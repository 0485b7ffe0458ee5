#!/usr/bin/env python
"""A/B measurements of B2/B3's tensor-core prefill body on one NVIDIA GPU.

Two parts, each run in one process so that both sides of a comparison
meet the same card, allocator and host state:

``kernel``: builds ``skycomputing_tpu_torch/ops/csrc/paged_attention.cu``
as it is and in variants, each from a patched copy of the source under
``build/variants/`` (one ``nvcc`` per variant, all started together):
the tensor-core prefill body at 1, 2 and 4 warps per block
(``kMmaWarps``), and at 4 warps with P rounded once to bf16 for P.V in
place of its bf16 head and tail (``p_once``), with its block width the
compile-time constant in place of ``blockDim.x`` (``constant_block``),
and with that constant and its five strided copy loops kept rolled by
hand (``rolled``).  Each variant runs the prefill and chunk waves of
``chip_smoke.py``'s kernel phase (GPT-2 small's heads, R=4, Lq 32, 64,
128 and 256, bf16 q over fp and int8 pages), checked against the plain
version and timed as that phase times a kernel (median of 30 calls on
the card's clock), the variants in turns, forward then backward; each
row's ``ms`` is the mean of the two.  Every variant but ``p_once``
keeps the shipped arithmetic and must agree within 2e-2.

``tile_variants``: where the register-tile body's time goes.  It is
built as it is (at the cases' head_dim 64, a compile-time constant), with
head_dim read at run time under its bound (``bound_d``, as the body runs
for a head_dim other than 32, 64 or 128) and with stages taken out (``no_scores``: the S = Q.K^T
products; ``no_pv``: the P.V products; ``no_walk``: the whole chunk walk,
leaving the query and table loads, the merge and the launch;
``no_merge``: the walk and the merge; ``empty``: everything, returning
at once; ``empty_no_smem``: that with no dynamic shared memory asked
for), from patched copies as in ``kernel``, and timed at the float32
prefill waves in turns; the variants' outputs, but ``bound_d``'s, are
wrong by construction and are not checked.

Prints one JSON object per row and writes them all to
``chiprun_out/prefill_ab.json``.  Usage::

    python3 prefill_ab.py [--part kernel|tile_variants|all]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# variant -> (text of the shipped source, its replacement); each text must
# occur exactly once
_PV_TAIL = (
    "        mma_bf16(o[2 * np], pt, vf[0], vf[1]);\n"
    "        mma_bf16(o[2 * np + 1], pt, vf[2], vf[3]);\n"
)
_WARPS = "constexpr int kMmaWarps = 4;"
_BLOCK = ("  const int threads = blockDim.x;\n"
          "  const int warps = threads / 32;\n"
          "  const int q_tile = warps * kMmaRows;\n")
_CONSTANT = (_BLOCK, _BLOCK.replace("blockDim.x", "kMmaThreads"))
# the body's strided copy loops, each with the newline before it
_LOOPS = (
    "\n  for (int e = tid; e < q_tile * kQChunks; e += threads) {",
    "\n  for (int i = tid; i < width; i += threads)\n",
    "\n      for (int e = tid; e < kKTile * kKVChunks; e += threads) {",
    "\n        for (int j = tid; j < kKTile; j += threads) {",
    "\n      for (int e = tid; e < 2 * kKTile * kKVChunks; e += threads) {",
)
VARIANTS = {
    "warps_1": [(_WARPS, "constexpr int kMmaWarps = 1;")],
    "warps_2": [(_WARPS, "constexpr int kMmaWarps = 2;")],
    "warps_4": [],
    "p_once": [(_PV_TAIL, "")],
    "constant_block": [_CONSTANT],
    "rolled": [_CONSTANT] + [(loop, "\n#pragma unroll 1" + loop)
                             for loop in _LOOPS],
}
# the register-tile body with one stage taken out (timing only)
_TILE_TOP = "  const int QS = Dp + 4;  // a float row of q_s, K or V"
_TILE_MERGE = "  // merge the warps' (m, l, acc); a warp that walked nothing"
TILE_VARIANTS = {
    "shipped": [],
    # head_dim read at run time, under its bound, as for a head_dim other
    # than 32, 64 or 128
    "bound_d": [("  const int D = kExactD ? kDMax : head_dim;",
                 "  const int D = head_dim;")],
    "no_merge": [("    if (ci >= n_chunks) break;\n    const int s = t % "
                  "kStages;\n    cp_async_wait<kStages - 1>();\n    "
                  "__syncwarp();\n    const unsigned char* kraw",
                  "    if (ci >= 0) break;\n    const int s = t % "
                  "kStages;\n    cp_async_wait<kStages - 1>();\n    "
                  "__syncwarp();\n    const unsigned char* kraw"),
                 (_TILE_MERGE, "  if (D > 0) return;\n" + _TILE_MERGE)],
    "empty": [(_TILE_TOP, "  if (D > 0) return;\n" + _TILE_TOP)],
    "empty_no_smem": [(_TILE_TOP, "  if (D > 0) return;\n" + _TILE_TOP),
                      ("  return tile_staging_offset(Dp, q_tile, width) + "
                       "(walk > merge ? walk : merge);",
                       "  return 0;")],
    "no_scores": [("      if (4 * c < D) {\n        float4 qv[kTileQPL]",
                   "      if (4 * c < D && D < 0) {\n"
                   "        float4 qv[kTileQPL]")],
    "no_pv": [("#pragma unroll 4\n    for (int j = 0; j < kChunk; ++j) {",
               "#pragma unroll 4\n    for (int j = 0; j < 0; ++j) {")],
    "no_walk": [("    const int ci = warp + t * kTileWarps;\n"
                 "    if (ci >= n_chunks) break;",
                 "    const int ci = warp + t * kTileWarps;\n"
                 "    if (ci >= 0) break;")],
}
# (case, R, Lq) of chip_smoke.py's kernel phase that the prefill body serves
PREFILL_CASES = (("prefill_32", 4, 32), ("chunk", 4, 64),
                 ("prefill", 4, 128), ("prefill_256", 4, 256))


def paged_module():
    """The module ``ops/paged_attention.py`` (the package ``ops`` exports
    its function of the same name)."""
    return importlib.import_module(
        "skycomputing_tpu_torch.ops.paged_attention")


def build_variant(name, patches):
    """Compile the patched source; returns (bound library, ptxas figures
    of each instantiation by label)."""
    from skycomputing_tpu_torch.ops import _build
    from skycomputing_tpu_torch.ops.paged_attention import bind

    source = (_build.CSRC / "paged_attention.cu").read_text()
    for old, new in patches:
        if source.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in the source once")
        source = source.replace(old, new)
    work = _build.BUILD_DIR.parent / "variants" / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, work)
    (work / "paged_attention.cu").write_text(source)
    target = work / f"libpaged_attention_{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(target),
         str(work / "paged_attention.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    ptxas = {cs.kernel_label(fn): info for fn, info in
             _build.parse_ptxas(proc.stdout + proc.stderr).items()}
    return bind(ctypes.CDLL(str(target))), ptxas


def kernel_part(torch, np):
    pa = paged_module()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda item: build_variant(*item), VARIANTS.items())))
    rows = []
    for name, (_, ptxas) in built.items():
        for label, info in sorted(ptxas.items()):
            if label.startswith("paged_attention_kernel_mma<"):
                row = dict(part="ptxas", variant=name, kernel_function=label,
                           **info)
                cs.log(json.dumps(row))
                rows.append(row)
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for int8 in (False, True):
        for ci, (case_name, R, Lq) in enumerate(PREFILL_CASES):
            case = cs.attention_case(torch, np, case_name, R, Lq, "bfloat16",
                                     seed=900 + 10 * int8 + ci, int8=int8)
            args, kw = cs.kernel_args(case)
            cs.check(pa.kernel_plan(torch.bfloat16, case["k"].dtype, Lq, 64,
                                    16) == "tensor_core",
                     f"{case_name} takes the tensor-core body")
            ref = pa.paged_attention_reference(*args, **kw).float()
            library_ms = cs.time_ms(torch, cs.library_call(torch, case))
            times = {name: [] for name in VARIANTS}
            errs = {}
            for name in order:
                with mock.patch.object(pa, "_lib", built[name][0]):
                    out = pa.paged_attention(*args, **kw)
                    torch.cuda.synchronize()
                    errs[name] = (out.float() - ref).abs().max().item()
                    times[name].append(cs.time_ms(
                        torch, lambda: pa.paged_attention(*args, **kw)))
            for name in VARIANTS:
                row = dict(part="kernel", variant=name, int8=int8,
                           case=case_name, R=R, Lq=Lq,
                           ms=sum(times[name]) / 2, ms_each=times[name],
                           max_abs_err=errs[name], library_ms=library_ms)
                cs.log(json.dumps(row))
                rows.append(row)
                if name != "p_once":  # the others keep the arithmetic
                    cs.check(errs[name] <= 2e-2,
                             f"{name} {case_name} int8={int8}: max |err| "
                             f"{errs[name]:.3g} <= 0.02")
            fastest = min((n for n in VARIANTS if n.startswith("warps_")),
                          key=lambda n: sum(times[n]))
            cs.log(f"   {case_name} int8={int8}: fastest {fastest}")
    return rows


def tile_variants_part(torch, np):
    """The register-tile body with a stage taken out at a time, timed at
    the float32 prefill waves (see the module docstring)."""
    pa = paged_module()
    with ThreadPoolExecutor(len(TILE_VARIANTS)) as pool:
        built = dict(zip(TILE_VARIANTS, pool.map(
            lambda item: build_variant(*item), TILE_VARIANTS.items())))
    rows = []
    for name, (_, ptxas) in built.items():
        for label, info in sorted(ptxas.items()):
            if label.startswith("paged_attention_kernel_tile<f32"):
                row = dict(part="ptxas", variant=name, kernel_function=label,
                           **info)
                cs.log(json.dumps(row))
                rows.append(row)
    order = list(TILE_VARIANTS) + list(reversed(TILE_VARIANTS))
    for int8 in (False, True):
        for ci, (case_name, R, Lq) in enumerate(PREFILL_CASES):
            case = cs.attention_case(torch, np, case_name, R, Lq, "float32",
                                     seed=970 + 10 * int8 + ci, int8=int8)
            args, kw = cs.kernel_args(case)
            times = {name: [] for name in TILE_VARIANTS}
            for name in order:
                with mock.patch.object(pa, "_lib", built[name][0]):
                    pa.paged_attention(*args, **kw)
                    torch.cuda.synchronize()
                    times[name].append(cs.time_ms(
                        torch, lambda: pa.paged_attention(*args, **kw)))
            for name in TILE_VARIANTS:
                row = dict(part="tile_variants", variant=name, int8=int8,
                           case=case_name, R=R, Lq=Lq,
                           ms=sum(times[name]) / 2, ms_each=times[name])
                cs.log(json.dumps(row))
                rows.append(row)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--part", choices=("kernel", "tile_variants", "all"),
                        default="all")
    opts = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    cs.log(smi.stdout.strip())
    rows = []
    if opts.part in ("kernel", "all"):
        rows += kernel_part(torch, np)
    if opts.part in ("tile_variants", "all"):
        rows += tile_variants_part(torch, np)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "prefill_ab.json").write_text(json.dumps(
        dict(card=smi.stdout.strip(), rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
