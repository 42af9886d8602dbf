"""Training launcher: the port's entry point for a decentralized run.

On the card (the default), reduced config, workers as a tensor axis —
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --algo moniqua --workers 8 --bits 8 --steps 50

The published config at a given batch and length —
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
        --full-size --workers 8 --batch 8 --seq 3000 --steps 3

The reference's production mesh (16 x 16 ranks a pod, ``--multi-pod``
2 pods), its rules (``ShardingRules(cfg.dist_mode, multi_pod=)``) and an
assigned input shape (``--shape``, default ``train_4k``), one rank a card
under ``torchrun`` (256 or 512 ranks; ``--device cpu``: gloo) —
    torchrun --nproc-per-node 8 --nnodes 32 --rdzv-endpoint HOST:PORT \\
        -m repro_torch.launch.train \\
        --arch qwen2-72b --mesh production --shape train_4k --full-size

``--device cpu`` runs the plain PyTorch versions of the kernels (the
tests); without a card, ``--device cuda`` raises.  ``--mesh cpu`` (the
default) keeps the reference's meaning: the workers are a tensor axis on
one device, and ``--multi-pod`` is ignored, as in the reference.  On the
production mesh the process group comes from the environment ``torchrun``
sets (``init_process_group`` with its ``env://``, NCCL on the cards).
The default, llama3.2-3b, runs there under the decentralized rules with
context-parallel attention (its 24 heads do not divide ``model`` = 16).
What the port does not run there yet (the families other than the dense
and MoE ones) exits 2 with the ``NotImplementedError`` naming ROADMAP
#13e.
"""
from __future__ import annotations

import argparse
import sys


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
                    help="cpu: the workers are a tensor axis on one device; "
                         "production: the reference's mesh under torchrun")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production mesh of two pods")
    ap.add_argument("--shape", default=None,
                    help="assigned input shape name (production mesh)")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full published config (default: reduced)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _production(args, cfg):
    """The reference's production mesh, rules and shape, over the default
    process group (initialised from ``torchrun``'s environment unless the
    caller did it)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_input_shape
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding import ShardingRules
    cuda = args.device != "cpu"
    if not dist.is_initialized():
        if cuda:
            import os
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo")
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type="cuda" if cuda else "cpu")
    rules = ShardingRules(cfg.dist_mode, multi_pod=args.multi_pod)
    return mesh, rules, get_input_shape(args.shape or "train_4k")


def main(argv=None) -> int:
    args = parse_args(argv)

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
    mesh = rules = None
    if args.mesh == "production":
        mesh, rules, shape = _production(args, cfg)
    else:
        shape = InputShape("cli", args.seq, args.batch, "train")

    tc = TrainerConfig(algo=args.algo, topology=args.topology,
                       n_workers=args.workers, bits=args.bits,
                       theta=args.theta, gamma=args.gamma, lr=args.lr,
                       steps=args.steps, log_every=args.log_every,
                       seed=args.seed, checkpoint_path=args.checkpoint,
                       checkpoint_every=0 if not args.checkpoint else 50)
    try:
        trainer = Trainer(model, tc, shape, mesh=mesh, rules=rules)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    lead = trainer.lead

    def log(k, m):
        if lead:
            print(f"step {k:5d}  loss {m['loss']:.4f}  alpha "
                  f"{m['alpha']:.4g}  theta {m['theta']:.3g}  g_inf "
                  f"{m['g_inf']:.3g}", flush=True)

    out = trainer.run(callback=log)
    if lead:
        print(f"bytes/step/worker = {out['bytes_per_step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
