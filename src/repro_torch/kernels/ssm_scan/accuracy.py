"""How close ``ssm_scan`` comes to its plain version and to the exact scan.

The inputs every check of the kernel draws (``inputs``), the same scan in
float64 (``scan_f64``: the exact result of the f32 values given, up to
float64's rounding), and the measure the checks use (``over_bound``).  Run
as a script, it holds this checkout's build of the kernel, and another
build if one is named, to both the plain version and the float64 scan over
several shapes, and times nothing:

    PYTHONPATH=src python -m repro_torch.kernels.ssm_scan.accuracy \\
        [--other-ops path/to/ops.py] [--other-source path/to/ssm_scan.cu] \\
        [--other-define NAME=VALUE ...] \\
        --shape B,S,D,N[,f32|,f16][,long|,mamba2] ...

The other build is loaded as ``repro_torch.kernels.ab`` loads it.  For
each shape it prints one JSON line: each build's largest |kernel - plain|
over 1e-5 + 1e-5 * |plain| (``vs_plain``: at most 1 where the build holds
the f32 tolerance of tests/test_kernels.py), each build's and the plain
version's largest distance from the float64 scan over the same bound
taken at the float64 value (``vs_f64``), for y and the final state apart
and for y also over its terms' size (``held_to_f64``), and the same for
``ops.kernel_order``, the kernel's order of summation
replayed with the plain version's exponentials, with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.ssm_scan.ref import mul_add

TOL = 1e-5                  # tests/test_kernels.py's f32 tolerance
F32_MIX = (torch.float32,) * 4
# dt, x, Bm, Cm as a bf16 model gives them: dt f32 after its softplus
MODEL_MIX = (torch.float32, torch.bfloat16, torch.bfloat16, torch.bfloat16)
# the same in an f16 model (dtype "float16")
F16_MIX = (torch.float32, torch.float16, torch.float16, torch.float16)
KINDS = ("softplus", "long", "mamba2")
MAMBA2_HEAD_DIM = 64        # zamba2-7b's ssm_head_dim


def inputs(b, s, d, n, dtypes=MODEL_MIX, kind="softplus", *, gen,
           dt_rank=256, head_dim=MAMBA2_HEAD_DIM):
    """(dt, A, Bm, Cm, x) on ``gen``'s device; ``dtypes`` gives dt, x, Bm
    and Cm's.  ``softplus``: dt = softplus(normal), A = -exp(0.3 normal).
    ``long``: Mamba's own ranges, each channel's dt around a level drawn
    log-uniform in [0.001, 0.1] and A = -(1..N), so that channels remember
    up to a thousand steps and an error in a decay adds up over them.  Bm
    and Cm are column slices of one (B, S, dt_rank + 2N) tensor, as the
    model's x_db gives them.  ``mamba2``: the call a Mamba2 layer makes
    (``models/ssm.py::_mamba2_channels``), heads of ``head_dim`` channels,
    each head's dt = softplus(normal - 2) (dt_bias -2) and A = -exp(0.5
    normal) repeated over its channels and A over the N states; x, Bm and
    Cm column slices of one silu-activated (B, S, D + 2N) tensor, as the
    layer's xbc_conv gives them."""
    dev = gen.device
    t_dt, t_x, t_b, t_c = dtypes

    def randn(*dims):
        return torch.randn(dims, generator=gen, device=dev)
    if kind == "softplus":
        dt = torch.nn.functional.softplus(randn(b, s, d))
        A = -torch.exp(0.3 * randn(d, n))
    elif kind == "long":
        level = torch.empty(d, device=dev).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen)
        dt = torch.exp(level + 0.5 * randn(b, s, d))
        A = -torch.arange(1, n + 1, device=dev,
                          dtype=torch.float32).expand(d, n).contiguous()
    elif kind == "mamba2":
        nh = d // head_dim
        if nh * head_dim != d:
            raise ValueError(f"D {d} is no whole number of {head_dim}-channel "
                             f"heads")
        dt = torch.nn.functional.softplus(randn(b, s, nh) - 2.0) \
            .repeat_interleave(head_dim, dim=-1)
        A = (-torch.exp(0.5 * randn(nh))).repeat_interleave(head_dim)[
            :, None].expand(d, n).contiguous()
        xbc = torch.nn.functional.silu(randn(b, s, d + 2 * n))
        return (dt.to(t_dt), A, xbc.to(t_b)[..., d:d + n],
                xbc.to(t_c)[..., d + n:], xbc.to(t_x)[..., :d])
    else:
        raise ValueError(f"input kind {kind!r}; one of {KINDS}")
    x_db = randn(b, s, dt_rank + 2 * n)
    return (dt.to(t_dt), A, x_db.to(t_b)[..., dt_rank:dt_rank + n],
            x_db.to(t_c)[..., dt_rank + n:], randn(b, s, d).to(t_x))


def parse_shape(shape: str) -> tuple:
    """``B,S,D,N[,f32|,f16][,long|,mamba2]`` -> (B, S, D, N, dtypes, kind):
    a bf16 model's dtypes unless ``f32`` or ``f16`` (an f16 model's),
    softplus inputs unless ``long`` or ``mamba2``."""
    fields = shape.split(",")
    opts = set(fields[4:])
    kinds, mixes = opts & {"long", "mamba2"}, opts & {"f32", "f16"}
    if len(fields) < 4 or opts - {"f32", "f16", "long", "mamba2"} or \
            len(kinds) > 1 or len(mixes) > 1:
        raise SystemExit(f"ssm_scan shapes are B,S,D,N[,f32|,f16]"
                         f"[,long|,mamba2], not {shape!r}")
    b, s, d, n = (int(v) for v in fields[:4])
    mix = {"f32": F32_MIX, "f16": F16_MIX}.get(mixes.pop() if mixes else "",
                                               MODEL_MIX)
    return b, s, d, n, mix, kinds.pop() if kinds else "softplus"


def scan_f64(dt, A, Bm, Cm, x):
    """y (B,S,D), the final state (B,D,N) and the size of y's terms,
    sum_n |h_n C_n| (B,S,D), of the plain version's recurrence in float64
    from the same values: what an exact scan of them gives, to float64's
    rounding, and so a witness of which of two f32 results is nearer."""
    dt, A, Bm, Cm, x = (t.double() for t in (dt, A, Bm, Cm, x))
    b, s, d = dt.shape
    h = torch.zeros((b, d, A.shape[1]), dtype=torch.float64, device=dt.device)
    y = torch.empty((b, s, d), dtype=torch.float64, device=dt.device)
    size = torch.empty_like(y)
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        terms = h * Cm[:, t, None, :]
        y[:, t] = terms.sum(-1)
        size[:, t] = terms.abs().sum(-1)
    return y, h, size


def terms(dt, A, Bm, Cm, x, state_dtype=torch.float32):
    """sum_n |h_n C_n| (B,S,D) of the recurrence with its state in
    ``state_dtype``, the plain version's (``ref.ssm_scan_ref``): the size
    of y's terms.  The kernel's bf16 or f16 state is the plain version's
    bit for bit, and its y sums the same f32 products in another order, so
    the two y differ by that sum's rounding, which scales with this size;
    an f32 state differs by the decays' few ulps too, which y's terms
    scale the same way."""
    dt, x, Bm, A = (t.float() for t in (dt, x, Bm, A))
    c = Cm.to(state_dtype).float().abs()
    b, s, d = dt.shape
    h = torch.zeros((b, d, A.shape[1]), dtype=state_dtype, device=dt.device)
    size = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * A).to(state_dtype)
        inp = ((dt[:, t] * x[:, t])[..., None]
               * Bm[:, t, None, :]).to(state_dtype)
        h = mul_add(decay, h, inp)
        size[:, t] = (h.float().abs() * c[:, t, None, :]).sum(-1)
    return size


def over_bound(out, ref, size=None) -> float:
    """The largest |out - ref| over TOL + TOL * size, with |ref| as the
    size by default: at most 1 where ``out`` holds the f32 tolerance
    against ``ref``.  For a sum, the size may be its terms' sum_n |h_n C_n|
    (``scan_f64``): where the terms cancel, that is what the sum's rounding
    scales with, whatever the order of summation."""
    o, r = out.double(), ref.double()
    size = r.abs() if size is None else size
    return float(((o - r).abs() / (TOL + TOL * size)).max())


def held_to_f64(out, exact) -> float:
    """How far a y and final state lie from the float64 scan ``exact``:
    the largest of y's error over TOL + TOL * sum_n |h_n C_n| and the
    state's over TOL + TOL * |state|; at most 1 where both hold."""
    y64, h64, size = exact
    return max(over_bound(out[0], y64, size), over_bound(out[1], h64))


def _each(out, ref) -> dict:
    """Largest errors over the bound: y and the state against ``ref``'s
    (plain or float64), and against float64 also y over its terms' size."""
    row = {"y": over_bound(out[0], ref[0]),
           "state": over_bound(out[1], ref[1])}
    if len(ref) == 3:
        row["y_by_terms"] = over_bound(out[0], ref[0], ref[2])
    return row


def main(argv=None) -> int:
    from repro_torch.kernels.ab import load_other
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other-ops", type=Path,
                    help="the other build's ops.py (default: this one's)")
    ap.add_argument("--other-source", type=Path,
                    help="the other build's kernel source")
    ap.add_argument("--other-define", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="a top-level constant of the other wrapper")
    ap.add_argument("--shape", action="append", required=True,
                    help="B,S,D,N[,f32|,f16][,long|,mamba2]; may be given "
                         "again")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("accuracy: no CUDA device is visible")
    this = importlib.import_module("repro_torch.kernels.ssm_scan.ops")
    builds = {"this": this}
    if args.other_ops or args.other_source or args.other_define:
        builds["other"] = load_other("ssm_scan",
                                     args.other_ops or Path(this.__file__),
                                     args.other_source, args.other_define)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for shape in args.shape:
        b, s, d, n, dtypes, kind = parse_shape(shape)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        xs = inputs(b, s, d, n, dtypes, kind, gen=gen)
        plain = this.ssm_scan_plain(*xs, return_state=True)
        exact = scan_f64(*xs)
        order = this.kernel_order(*xs)
        row = {"shape": shape, "seed": args.seed,
               "plain": {"vs_f64": _each(plain, exact)},
               "order": {"vs_plain": _each(order, plain),
                         "vs_f64": _each(order, exact)}}
        for name, mod in builds.items():
            out = mod.ssm_scan(*xs, return_state=True)
            row[name] = {"vs_plain": _each(out, plain),
                         "vs_f64": _each(out, exact)}
        print(json.dumps({**row, "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
