"""Gossip: the flat bucket, circulant rolls and the CommEngine round."""
