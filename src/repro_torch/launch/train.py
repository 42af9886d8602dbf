"""Training launcher: the port's entry point for a decentralized run.

On the card (the default), reduced config, workers as a tensor axis —
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --algo moniqua --workers 8 --bits 8 --steps 50

The published config at a given batch and length —
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
        --full-size --workers 8 --batch 8 --seq 3000 --steps 3

``--device cpu`` runs the plain PyTorch versions of the kernels (the
tests); without a card, ``--device cuda`` raises.  ``--mesh cpu`` (the
default) keeps the reference's meaning: the workers are a tensor axis on
one device.  ``--mesh production`` and ``--multi-pod`` need the port's
meshes, which are not written yet (ROADMAP #13d): they exit non-zero.
"""
from __future__ import annotations

import argparse
import sys

MESH_TODO = ("--mesh production and --multi-pod need repro_torch's meshes "
             "(launch/mesh.py, models/sharding.py), not ported yet: ROADMAP "
             "Queue 1 #13d")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--algo", default="moniqua",
                    help="allreduce|dpsgd|naive|moniqua|choco|deepsqueeze|"
                         "dcd|ecd|d2|moniqua_d2")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--theta", type=float, default=2.0)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--mesh", choices=["cpu", "production"], default="cpu",
                    help="cpu: the workers are a tensor axis on one device "
                         "(production: ROADMAP #13d)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported yet (ROADMAP #13d)")
    ap.add_argument("--shape", default=None,
                    help="assigned input shape name (production mesh)")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full published config (default: reduced)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh == "production" or args.multi_pod:
        print(f"error: {MESH_TODO}", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.device import resolve_device
    from repro_torch.models.model_factory import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig

    resolve_device(args.device)             # raises without the card
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    shape = InputShape("cli", args.seq, args.batch, "train")

    tc = TrainerConfig(algo=args.algo, topology=args.topology,
                       n_workers=args.workers, bits=args.bits,
                       theta=args.theta, gamma=args.gamma, lr=args.lr,
                       steps=args.steps, log_every=args.log_every,
                       seed=args.seed, checkpoint_path=args.checkpoint,
                       checkpoint_every=0 if not args.checkpoint else 50)
    trainer = Trainer(model, tc, shape)

    def log(k, m):
        print(f"step {k:5d}  loss {m['loss']:.4f}  alpha {m['alpha']:.4g}  "
              f"theta {m['theta']:.3g}  g_inf {m['g_inf']:.3g}", flush=True)

    out = trainer.run(callback=log)
    print(f"bytes/step/worker = {out['bytes_per_step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
