"""Are the kernels' outputs bitwise those of another copy of the CUDA sources?

    python -m nsfnet_tpu_torch.tools.compare_sources <directory with *.cu / *.cuh>

Builds the fused residual-loss pair and the five-stream pair from this
checkout's csrc/ and from the given directory (for example the csrc/ of an
earlier commit, unpacked with `git archive`), runs kernels 1-4 from both
builds on the same seeded inputs on the card (6x80 / N = 120,000 with EVM,
4x120 / N = 40,000) and compares every output with torch.equal. Exits 1 on
any difference. Use it after touching a header the kernels share.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from nsfnet_tpu_torch.models.mlp import flatten_params, init_mlp, layer_sizes
from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import mlp_streams as ms

CASES = {"6x80": (layer_sizes(2, 3, 6, 80), 120_000), "4x120": (layer_sizes(2, 3, 4, 120), 40_000)}


def run_kernels(csrc: Path) -> dict:
    """Outputs of kernels 1-4 built from `csrc`, by case and kernel."""
    _build.CSRC = Path(csrc).resolve()
    _build._loaded.clear()
    fr._lib.cache_clear()
    ms._lib.cache_clear()
    dev, out = torch.device("cuda", 0), {}
    for name, (sizes, n) in CASES.items():
        g = torch.Generator().manual_seed(0)
        flat = flatten_params(init_mlp(sizes, g)).to(dev)
        x = (2.0 * torch.rand((n, 2), generator=g) - 1.0).to(dev)
        e = (0.05 * torch.randn((n, 1), generator=g)).to(dev)
        vis_t = (0.01 * torch.rand((n, 1), generator=g)).to(dev)
        eq_w = (0.2 + torch.rand((n, 1), generator=g)).to(dev)
        ct = torch.tensor([1.0, 1.0, 1.0, 0.1], device=dev) / n
        cts = [torch.randn((n, 3), generator=g).to(dev) for _ in range(5)]
        args = (flat, sizes, x, e, vis_t, eq_w, 2000.0)
        dflat, g_e = fr.fused_bwd(*args, ct, 1.0, True)
        out[name] = {"fused_residual_fwd": [fr.fused_fwd(*args, 1.0, True)],
                     "fused_residual_bwd": [dflat, g_e],
                     "mlp_streams_fwd": list(ms.streams_fwd(flat, sizes, x)),
                     "mlp_streams_bwd": [ms.streams_bwd(flat, sizes, x, cts)]}
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_sources: no CUDA device; the kernels run on the card", file=sys.stderr)
        return 1
    here = _build.CSRC
    try:
        mine, theirs = run_kernels(here), run_kernels(Path(argv[0]))
    finally:
        _build.CSRC = here
    same = True
    for case, kernels in mine.items():
        for kernel, tensors in kernels.items():
            eq = all(torch.equal(a, b) for a, b in zip(tensors, theirs[case][kernel]))
            same = same and eq
            print(f"{kernel} {case}: bitwise equal to the build from {argv[0]}: {eq}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
