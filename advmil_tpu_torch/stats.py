"""Model statistics: parameter counts and forward FLOPs per backbone (the
port's counterpart of `advmil_tpu/stats.py`, the reference's thop / ptflops
profiling, reference model_stats.py:142-180).

Usage:
  python -m advmil_tpu_torch.stats --mode patch --n 3360 [--dims 1024-384-384]
      [--batch 1] [--device cuda|cpu]

The model is the JAX module's: a Generator (noise 0-1, one hop, sigmoid)
over the backbone with the reference's defaults, run deterministic (eval
mode) with zero noise on an all-ones mask of n patches rounded up to 16.
It takes the plain versions of every op (`use_pallas=False`, as the JAX
module builds it, and the plain LN-pool), since the hand-written kernels
have no FLOP formula. FLOPs come from `torch.utils.flop_counter.
FlopCounterMode`, which counts the products (matmul, einsum, attention) at
2 per multiply-add; XLA's cost analysis, which the JAX module reads, also
counts elementwise operations, so its total is larger.
"""
from __future__ import annotations

import argparse

import torch

from .models.backbones import load_backbone
from .models.gan import Generator
from .models.layers import init_parameters


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def build_inputs(mode: str, dims, n_patches: int, batch: int, device,
                 edges_per_node: int = 9):
    """(feats, mask, extra) as the JAX module builds them: zeros, every patch
    real; cluster ids 0; in graph mode the dense route's tables (every node's
    edges from node 0)."""
    n = ((n_patches + 15) // 16) * 16
    feats = torch.zeros((batch, n, dims[0]), device=device)
    mask = torch.ones((batch, n), device=device)
    if mode == "cluster":
        extra = torch.zeros((batch, n), dtype=torch.int32, device=device)
    elif mode == "graph":
        extra = {"edge_src": torch.zeros((batch, n, edges_per_node), dtype=torch.int32,
                                         device=device),
                 "edge_mask": torch.ones((batch, n, edges_per_node), device=device)}
    else:
        extra = None
    return feats, mask, extra


def backbone_stats(mode: str, dims, n_patches: int, batch: int = 1,
                   edges_per_node: int = 9, device: str = "cpu") -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    backbone = load_backbone(mode, dims, use_pallas=False, use_lnpool=False)
    gen = Generator(backbone, dims[1], 1, noise=(0, 1), hops=1, out_scale="sigmoid")
    init_parameters(gen, 0)
    gen.to(device).eval()
    feats, mask, extra = build_inputs(mode, dims, n_patches, batch, device,
                                      edges_per_node)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        out = gen(feats, mask, extra, zero_noise=True)
    assert out.shape == (batch, 1) and bool(torch.isfinite(out).all())
    return {"mode": mode, "n_patches": feats.shape[1], "params": count_params(gen),
            "flops_forward": float(counter.get_total_flops())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="patch",
                    choices=["patch", "abmil", "cluster", "graph"])
    ap.add_argument("--dims", default="1024-384-384")
    ap.add_argument("--n", type=int, default=3360,
                    help="patches per bag (reference patient 128599 @20x)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is False "
                         "(pass --device cpu)")
    dims = [int(x) for x in args.dims.split("-")]
    s = backbone_stats(args.mode, dims, args.n, args.batch, device=args.device)
    print(f"mode={s['mode']} n_patches={s['n_patches']} "
          f"params={s['params'] / 1e6:.3f}M "
          f"fwd_flops={s['flops_forward'] / 1e9:.3f}G")
    return s


if __name__ == "__main__":
    main()
