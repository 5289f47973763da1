"""Do the kernels give the outputs of another copy of the CUDA sources?

    python -m nsfnet_tpu_torch.tools.compare_sources <directory with *.cu / *.cuh>
        [--kernels 1,2,3,4,5,6] [--time] [--precision high]

Builds the libraries from this checkout's csrc/ and from the given directory
(for example the csrc/ of an earlier commit, unpacked with `git archive`),
runs the chosen kernels from both builds on the same seeded inputs on the
card and compares their outputs, at 6x80 / N = 120,000 and 4x120 /
N = 40,000 (K = 3 for kernels 1-4, K = 2 for kernels 5+6; kernels 1+2 with
EVM at the benchmark's two shapes instead: 6x80 at Re 2000 and 6x160 at
Re 4000, N = 120,000), every kernel at one precision name (--precision,
"high" by default; a copy from before the tensor cores runs exact fp32):

  * a kernel whose design is the same in both copies must be bitwise equal
    (torch.equal); a copy from before the streamed plan (its C interface
    takes no kpanel and no carries) is called through that interface, on
    the resident plan both copies share at these widths;
  * a kernel of the other copy from before its tensor-core design (exact
    fp32 on the CUDA cores, called through its old C interface: kernels
    1+2 before the tensor-core pair, kernels 4 and 6 before the tensor-core
    backwards, kernels 3 and 5 before the tensor-core forwards) is reported
    as the largest relative difference, max|a - b| / max|b| per output.

With --time it also times each kernel of both builds with CUDA events, in
turns in one process (this checkout, the other, the other, this), for
kernels whose design both copies share. Exits 1 when a kernel that must be
bitwise equal differs. Use it after touching a header the kernels share.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

from nsfnet_tpu_torch.models.mlp import flatten_params, init_mlp, layer_sizes, param_count
from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import mlp_streams as ms
from nsfnet_tpu_torch.ops import psi_streams as psi

CASES = {"6x80": 120_000, "4x120": 40_000}
PAIR_CASES = {"6x80": (80, 2000.0), "6x160": (160, 4000.0)}  # kernels 1+2: width, Re
LEGACY_BLOCKS = 264  # the CUDA-core kernels' fixed grid
_load = _build.load  # the legacy calls below set their own argument types


def _inputs(sizes, n, dev):
    g = torch.Generator().manual_seed(0)
    flat = flatten_params(init_mlp(sizes, g)).to(dev)
    x = (2.0 * torch.rand((n, 2), generator=g) - 1.0).to(dev)
    return g, flat, x


def _legacy_tile(h, k, n_streams):
    """The tile of the CUDA-core kernels: the largest of 16, 8, 4, 2, 1
    points whose block (two packed carries of n_streams rows, the weight at
    row stride h+1, the head block, and the five-stream kernels' loss
    terms) fits in shared memory."""
    for t in (16, 8, 4, 2, 1):
        floats = (2 * n_streams * t * h + h * (h + 1) + n_streams * t * k
                  + (4 * t if n_streams == 5 else 0))
        if 4 * floats <= fr._MAX_SMEM:
            return t
    raise ValueError(f"hidden width {h} does not fit the CUDA-core kernels")


def _legacy_pair(lib, flat, sizes, x, e, vis_t, eq_w, re, ct):
    """Kernels 1+2 of a copy whose C interface predates the tensor-core pair."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [p, p, p, p, p, i, i, i, i, i, i, f, f, i]
    lib.nsf_fused_loss_fwd.argtypes = common + [p, p, p]
    lib.nsf_fused_loss_bwd.argtypes = common + [p, p, p, p, p, p]
    lib.nsf_fused_loss_scratch_floats.argtypes = [i, i, i]
    lib.nsf_fused_loss_scratch_floats.restype = ctypes.c_long
    n, dev, nparam = x.shape[0], x.device, param_count(sizes)
    tile = _legacy_tile(sizes[1], 3, 5)  # the CUDA-core pair shared kernels 3+4's tile rule
    args = [x.data_ptr(), flat.data_ptr(), e.data_ptr(), vis_t.data_ptr(), eq_w.data_ptr(), n,
            len(sizes) - 2, sizes[1], sizes[-1], tile, LEGACY_BLOCKS, re, 1.0, 1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(LEGACY_BLOCKS * 4, device=dev)
    sums = torch.empty(4, device=dev)
    scratch = torch.empty(
        LEGACY_BLOCKS * lib.nsf_fused_loss_scratch_floats(tile, sizes[1], len(sizes) - 2),
        device=dev)
    dpart = torch.empty(LEGACY_BLOCKS * nparam, device=dev)
    dflat, g_e = torch.empty(nparam, device=dev), torch.empty((n, 1), device=dev)
    codes = (lib.nsf_fused_loss_fwd(*args, partial.data_ptr(), sums.data_ptr(), stream),
             lib.nsf_fused_loss_bwd(*args, ct.data_ptr(), scratch.data_ptr(), dpart.data_ptr(),
                                    dflat.data_ptr(), g_e.data_ptr(), stream))
    if any(codes):
        raise RuntimeError(f"legacy fused pair: CUDA errors {codes}")
    return [sums], [dflat, g_e]


def _legacy_engine_args(prefix, flat, sizes, x, n_streams):
    """What the CUDA-core forward and backward of a stream engine (prefix
    nsf_mlp_streams or nsf_psi_streams) take first, and how its stream
    pointers are passed: the five-stream engine one argument each, the
    order-3 engine as a host array."""
    p, i = ctypes.c_void_p, ctypes.c_int
    n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
    tile = _legacy_tile(h, k, 13 if prefix == "nsf_psi_streams" else 5)
    if prefix == "nsf_psi_streams":
        ptrs, types = (lambda ts: [(p * len(ts))(*(t.data_ptr() for t in ts))]), \
            [ctypes.POINTER(p)]
    else:
        ptrs, types = (lambda ts: [t.data_ptr() for t in ts]), [p] * n_streams
    args = [x.data_ptr(), flat.data_ptr(), x.shape[0], n_hidden, h, k, tile, LEGACY_BLOCKS]
    return args, [p, p, i, i, i, i, i, i] + types, ptrs, tile


def _legacy_fwd(lib, prefix, flat, sizes, x, n_streams):
    """The CUDA-core forward of a stream engine (exact fp32, 264 blocks)
    through its old C interface."""
    args, types, ptrs, _ = _legacy_engine_args(prefix, flat, sizes, x, n_streams)
    fwd = getattr(lib, prefix + "_fwd")
    fwd.argtypes, fwd.restype = types + [ctypes.c_void_p], ctypes.c_int
    outs = [torch.empty((x.shape[0], sizes[-1]), device=x.device) for _ in range(n_streams)]
    code = fwd(*args, *ptrs(outs), torch.cuda.current_stream(x.device).cuda_stream)
    if code:
        raise RuntimeError(f"legacy {prefix} forward: CUDA error {code}")
    return outs


def _legacy_bwd(lib, prefix, flat, sizes, x, cts):
    """The CUDA-core backward of a stream engine (exact fp32, 264 blocks,
    block-private scratch) through its old C interface."""
    p = ctypes.c_void_p
    args, types, ptrs, tile = _legacy_engine_args(prefix, flat, sizes, x, len(cts))
    bwd, floats = getattr(lib, prefix + "_bwd"), getattr(lib, prefix + "_scratch_floats")
    bwd.argtypes, bwd.restype = types + [p, p, p, p], ctypes.c_int
    floats.argtypes, floats.restype = [ctypes.c_int] * 3, ctypes.c_long
    dev, nparam = x.device, param_count(sizes)
    scratch = torch.empty(LEGACY_BLOCKS * floats(tile, sizes[1], len(sizes) - 2), device=dev)
    dpart, dflat = torch.empty(LEGACY_BLOCKS * nparam, device=dev), torch.empty(nparam, device=dev)
    code = bwd(*args, *ptrs(cts), scratch.data_ptr(), dpart.data_ptr(), dflat.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    if code:
        raise RuntimeError(f"legacy {prefix} backward: CUDA error {code}")
    return [dflat]


def _modern(csrc: Path, source: str, header: str) -> bool:
    return f'"{header}"' in (csrc / source).read_text()


class _Truncated:
    """An entry point of a library from before the streamed plan, called
    with the current interface: the trailing plan arguments (kpanel, and the
    carries of the forwards and backwards) are dropped, and must be those of
    the resident plan (0, None)."""

    def __init__(self, fn, drop):
        self._fn, self._drop = fn, drop

    @property
    def argtypes(self):
        return self._fn.argtypes

    @argtypes.setter
    def argtypes(self, types):
        self._fn.argtypes = types[:-self._drop]

    @property
    def restype(self):
        return self._fn.restype

    @restype.setter
    def restype(self, t):
        self._fn.restype = t

    def __call__(self, *args):
        if any(args[len(args) - self._drop:]):
            raise ValueError("a copy from before the streamed plan runs the resident plan only")
        return self._fn(*args[:-self._drop])


class _NoCarries:
    """`*_carry_floats` of a library from before the streamed plan."""
    argtypes = restype = None

    def __call__(self, *args):
        return 0


class _Unplanned:
    """A library built from sources from before the streamed plan, seen
    through the current C interface."""
    APPENDED = (("_fwd", 2), ("_bwd", 2), ("_smem_bytes", 1))

    def __init__(self, lib):
        self._lib, self._fns = lib, {}

    def __getattr__(self, name):
        if name not in self._fns:
            drop = dict((s, d) for s, d in self.APPENDED if name.endswith(s))
            self._fns[name] = (_NoCarries() if name.endswith("_carry_floats")
                               else _Truncated(getattr(self._lib, name), *drop.values())
                               if drop else getattr(self._lib, name))
        return self._fns[name]


def _ms(fn, iters=10):
    """Mean ms of fn() on the card over `iters` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_kernels(csrc: Path, kernels, timed: bool = False, precision: str = "high") -> dict:
    """Outputs of the chosen kernels built from `csrc` at the precision
    name, by case and kernel: (name, tensors, bitwise, ms) with bitwise
    False for a design from before the tensor cores; ms (timed, and bitwise
    only) the kernel's mean time, else None."""
    _build.CSRC = Path(csrc).resolve()
    _build._loaded.clear()
    for mod in (fr, ms, psi):
        mod._lib.cache_clear()
    header = _build.CSRC / "tc_mlp.cuh"
    if not header.exists() or "kpanel" not in header.read_text():
        _build.load = lambda name: _Unplanned(_load(name))
    try:
        return _run(kernels, timed, precision)
    finally:
        _build.load = _load
        for mod in (fr, ms, psi):
            mod._lib.cache_clear()


def _run(kernels, timed, precision) -> dict:
    dev, out = torch.device("cuda", 0), {}

    def entry(name, call, modern):
        return (name, call(), modern, _ms(call) if timed and modern else None)

    for case, (width, re) in PAIR_CASES.items():
        if not kernels & {1, 2}:
            break
        sizes = layer_sizes(2, 3, 6, width)
        n = CASES["6x80"]
        g, flat, x = _inputs(sizes, n, dev)
        e = (0.05 * torch.randn((n, 1), generator=g)).to(dev)
        vis_t = (0.01 * torch.rand((n, 1), generator=g)).to(dev)
        eq_w = (0.2 + torch.rand((n, 1), generator=g)).to(dev)
        ct = torch.tensor([1.0, 1.0, 1.0, 0.1], device=dev) / n
        modern = _modern(_build.CSRC, "fused_residual.cu", "tc_mlp.cuh")
        if modern:
            args = (flat, sizes, x, e, vis_t, eq_w, re)
            out[case] = {
                1: entry("fused_residual_fwd",
                         lambda: [fr.fused_fwd(*args, 1.0, True, precision)], True),
                2: entry("fused_residual_bwd",
                         lambda: list(fr.fused_bwd(*args, ct, 1.0, True, precision)), True)}
        else:
            fwd, bwd = _legacy_pair(_load("fused_residual"), flat, sizes, x, e, vis_t,
                                    eq_w, re, ct)
            out[case] = {1: ("fused_residual_fwd", fwd, False, None),
                         2: ("fused_residual_bwd", bwd, False, None)}
    engines = ((3, 4, 3, 5, "mlp_streams", ms.streams_fwd, ms.streams_bwd, "tc_mlp.cuh"),
               (5, 6, 2, 13, "psi_streams", psi.psi_fwd, psi.psi_bwd, "tc_psi.cuh"))
    for case, n in CASES.items():
        got = out.setdefault(case, {})
        depth, width = (6, 80) if case == "6x80" else (4, 120)
        for kf, kb, k, n_streams, name, fwd, bwd, header in engines:
            if not kernels & {kf, kb}:
                continue
            sizes = layer_sizes(2, k, depth, width)
            g, flat, x = _inputs(sizes, n, dev)
            cts = [torch.randn((n, k), generator=g).to(dev) for _ in range(n_streams)]
            # the CUDA-core forwards ran forward_tile / psi_forward_tile
            fwd_modern = "forward_tile(" not in (_build.CSRC / f"{name}.cu").read_text()
            bwd_modern = _modern(_build.CSRC, f"{name}.cu", header)
            lib, prefix = _load(name), f"nsf_{name}"
            got[kf] = entry(f"{name}_fwd", lambda: list(fwd(flat, sizes, x, precision))
                            if fwd_modern else _legacy_fwd(lib, prefix, flat, sizes, x, n_streams),
                            fwd_modern)
            got[kb] = entry(f"{name}_bwd", lambda: [bwd(flat, sizes, x, cts, precision)]
                            if bwd_modern else _legacy_bwd(lib, prefix, flat, sizes, x, cts),
                            bwd_modern)
    torch.cuda.synchronize()
    return {case: {k: v for k, v in got.items() if k in kernels} for case, got in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", type=Path)
    ap.add_argument("--kernels", default="1,2,3,4,5,6",
                    help="comma-separated kernel numbers, 1-6 (default: all)")
    ap.add_argument("--time", action="store_true",
                    help="also time both builds' kernels, in turns in this process")
    ap.add_argument("--precision", default="high", choices=fr.PRECISIONS,
                    help="the precision name every kernel runs at (default: high)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    kernels = {int(k) for k in a.kernels.split(",")}
    if not kernels <= set(range(1, 7)):
        ap.error(f"kernels are numbered 1-6, got {a.kernels}")
    if not torch.cuda.is_available():
        print("compare_sources: no CUDA device; the kernels run on the card", file=sys.stderr)
        return 1
    here = _build.CSRC
    try:
        mine = run_kernels(here, kernels, a.time, a.precision)
        theirs = run_kernels(a.csrc, kernels, a.time, a.precision)
        if a.time:  # the second turn, in the other order
            again = (run_kernels(a.csrc, kernels, True, a.precision),
                     run_kernels(here, kernels, True, a.precision))
    finally:
        _build.CSRC = here
        _build._loaded.clear()
        for mod in (fr, ms, psi):
            mod._lib.cache_clear()
    same = True
    for case, got in mine.items():
        for k, (name, tensors, _, ms_) in sorted(got.items()):
            _, ref, bitwise, their_ms = theirs[case][k]
            if a.time and ms_ is not None and their_ms is not None:
                print(f"{name} {case} {a.precision!r}: {ms_:.4f} / {again[1][case][k][3]:.4f} ms "
                      f"here, {their_ms:.4f} / {again[0][case][k][3]:.4f} ms from {a.csrc} "
                      f"(turns: here, there, there, here; {torch.cuda.get_device_name(0)})")
            if not bitwise:
                rel = max(((t - r).abs().max() / r.abs().max()).item()
                          for t, r in zip(tensors, ref))
                print(f"{name} {case}: max relative difference from the build from "
                      f"{a.csrc} (its design predates the tensor cores): {rel:.3e}")
                continue
            eq = all(torch.equal(t, r) for t, r in zip(tensors, ref))
            same = same and eq
            print(f"{name} {case} {a.precision!r}: bitwise equal to the build from {a.csrc}: {eq}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
