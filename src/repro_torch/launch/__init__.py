"""Entry points: the training CLI, the dry run and its depth-probe calibration."""
