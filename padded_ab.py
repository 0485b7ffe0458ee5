#!/usr/bin/env python
"""A/B of B1's and B2/B3's padded routes against the bodies they
replaced, on one NVIDIA GPU.

B1 once ran a head_dim that is not a multiple of its mma's k-step
(float32 D % 8 != 0, bfloat16 D % 16 != 0) on a CUDA-core body of
float32 FMAs, and B2/B3 a K/V row that is not whole 16-byte chunks on a
query-tile body; both now run on the tensor-core, decode and
register-tile bodies, each row padded in shared memory.  This builds
the kernels of an earlier checkout (``--parent DIR``: a ``git archive``
of the earlier commit unpacked under ``build/``) beside this
checkout's, and at each case calls the earlier library's body directly
(through ``ctypes``, with its own C signature, on the body its own plan
names) and this checkout's wrapper, each checked against the plain
version (float32 B1 against the plain version in float64) and timed as
``chip_smoke.py``'s kernel phase times a kernel, in turns (earlier,
this, this, earlier), beside the plain version's and SDPA's times and
the call's bound.

Cases: B1 at B=4, L=128, H=16, the last 32 keys padded: float32 at
D=36 and 37, bfloat16 at D=40 and 37 (the CUDA-core body before), and
both dtypes at D=64 (the tensor-core bodies on both sides: the main
path's rows, re-read).  B2/B3 at GPT-2 small's 12 heads over pages of
16 (a 512-page pool, tables of 32 pages), decode R=16, Lq=1 and prefill
R=4, Lq=128: bfloat16 pages at D=36 (72-byte rows), int8 pages under
bfloat16 q at D=40 (40 bytes), float32 pages at D=30 (120 bytes) (the
query-tile body before); and at D=64 the decode body over bfloat16 and
int8 pages and the register-tile body's float32 prefill over float32
and int8 pages (the same bodies on both sides, re-read).  First come
the ``nvcc`` seconds of each library, all four built at once.

Prints one JSON object per row, writes them all to
``chiprun_out/padded_ab_<part>.json``, and exits 1 if a row's error is past
its tolerance (bf16 2e-2, float32 1e-4).  Usage::

    python3 padded_ab.py --parent DIR [--part before|ab]

``before`` times the earlier bodies alone and builds nothing of this
checkout; ``ab`` (the default) times both, in turns.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCES = ("flash_attention", "paged_attention")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (dtype, D) of B1 at B=4, L=128, H=16, 32 keys padded
FLASH_CASES = (("float32", 36), ("bfloat16", 40), ("float32", 37),
               ("bfloat16", 37), ("bfloat16", 64), ("float32", 64))
FLASH_SHAPE = (4, 128, 16, 32)  # B, L, H, padded keys
# (q dtype, int8 pages, D) of B2/B3, each at every PAGED_CALLS entry
PAGED_ROWS = (("bfloat16", False, 36), ("bfloat16", True, 40),
              ("float32", False, 30), ("bfloat16", False, 64),
              ("bfloat16", True, 64), ("float32", False, 64),
              ("float32", True, 64))
PAGED_CALLS = (("decode", 16, 1), ("prefill", 4, 128))
# the rows re-read at D=64 time only the call the main path makes there
WHOLE_ROW_CALLS = {("bfloat16", False): "decode", ("bfloat16", True): "decode",
                   ("float32", False): "prefill", ("float32", True): "prefill"}


def load_module(path: Path, name: str):
    """A kernel wrapper module of the earlier checkout, loaded alone (its
    top level imports only ``ctypes``, ``typing`` and ``torch``): its
    plan, body names and dtype codes."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def nvcc_parent(parent: Path, stem: str):
    """Build the earlier checkout's ``csrc/<stem>.cu`` with its own
    ``nvcc`` flags under ``build/parent_kernels/``; returns (library
    path, seconds)."""
    from skycomputing_tpu_torch.ops import _build

    ops = parent / "skycomputing_tpu_torch" / "ops"
    flags = load_module(ops / "_build.py", "earlier_build").NVCC_FLAGS
    out = ROOT / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    target = out / f"lib{stem}.so"
    source = ops / "csrc" / f"{stem}.cu"
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc_path(), *flags, "-o", str(target),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    return target, time.perf_counter() - t0


def nvcc_here(stem: str):
    """Build this checkout's ``csrc/<stem>.cu``; (library path, seconds)."""
    from skycomputing_tpu_torch.ops import _build

    t0 = time.perf_counter()
    return _build.build(stem), time.perf_counter() - t0


def build_all(parent: Path, here: bool):
    """Every library, built at once; {side: {stem: path}} and a row of
    each build's seconds."""
    jobs = [("earlier", stem) for stem in SOURCES]
    if here:
        jobs += [("this", stem) for stem in SOURCES]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        done = list(pool.map(
            lambda job: nvcc_parent(parent, job[1]) if job[0] == "earlier"
            else nvcc_here(job[1]), jobs))
    libs, seconds = {}, {}
    for (side, stem), (path, s) in zip(jobs, done):
        libs.setdefault(side, {})[stem] = path
        seconds[f"{side}:{stem}"] = s
    return libs, dict(part="nvcc", seconds=seconds)


def earlier_flash(torch, lib, mod):
    """A callable of the earlier B1 library on the body its plan names."""
    lib.sky_flash_attention.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    lib.sky_flash_attention.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def make(q, k, v, bias, scale):
        B, L, H, D = q.shape
        plan = mod.kernel_plan(q.dtype, B, L, H, D, sms)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = lib.sky_flash_attention(
                mod._BODIES.index(plan["body"]), plan["warps"],
                mod._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), bias.data_ptr(), mod._DTYPE_CODES[bias.dtype],
                bias.stride(0), bias.stride(1), out.data_ptr(), B, L, H, D,
                float(scale), stream)
            if rc != 0:
                raise RuntimeError(f"earlier B1 launch failed: {rc}")
            return out

        return plan["body"], call

    return make


def earlier_paged(torch, lib, mod):
    """A callable of the earlier B2/B3 library on the body its plan
    names."""
    mod.bind(lib)

    def make(case):
        (q, k, v, table, index), kw = cs.kernel_args(case)
        R, Lq, H, D = q.shape
        body = mod.kernel_plan(q.dtype, k.dtype, Lq, D, case["PS"])
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        head = (mod._BODIES.index(body), mod._DTYPE_CODES[q.dtype],
                q.data_ptr(), k.data_ptr(), v.data_ptr())
        tail = (table.data_ptr(), index.data_ptr(), out.data_ptr(), R, Lq, H,
                D, case["P"], case["PS"], table.shape[1], D ** -0.5, stream)

        def call():
            if kw:
                rc = lib.sky_paged_attention_int8(
                    *head, kw["k_scale"].data_ptr(),
                    kw["v_scale"].data_ptr(), *tail)
            else:
                rc = lib.sky_paged_attention(*head, *tail)
            if rc != 0:
                raise RuntimeError(f"earlier B2/B3 launch failed: {rc}")
            return out

        return body, call

    return make


def max_err(out, ref) -> float:
    return (out.double() - ref.double()).abs().max().item()


def in_turns(torch, earlier, this):
    """(earlier's two times, this side's two times), in the order
    earlier, this, this, earlier; ``this`` None times ``earlier`` alone."""
    if this is None:
        return [cs.time_ms(torch, earlier)], None
    a = cs.time_ms(torch, earlier)
    b = [cs.time_ms(torch, this), cs.time_ms(torch, this)]
    return [a, cs.time_ms(torch, earlier)], b


def flash_rows(torch, np, make_earlier, here):
    import torch.nn.functional as F
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        kernel_plan,
    )

    B, L, H, tail = FLASH_SHAPE
    rows = []
    for dtype, D in FLASH_CASES:
        rng = np.random.default_rng(400 + D)
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D))
                                    .astype(np.float32)).to("cuda", dt)
                   for _ in range(3))
        bias = torch.zeros(B, L)
        bias[:, -tail:] = -10000.0
        bias = bias.to("cuda", dt)
        scale = D ** -0.5
        ref = flash_attention_reference(
            q, k, v, bias, scale, compute_dtype=(
                torch.float64 if dtype == "float32" else torch.float32))
        earlier_body, earlier = make_earlier(q, k, v, bias, scale)
        earlier_err = max_err(earlier(), ref)
        this = (lambda: flash_attention(q, k, v, bias)) if here else None
        ms_earlier, ms_this = in_turns(torch, earlier, this)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        plan = kernel_plan(q.dtype, B, L, H, D, torch.cuda.get_device_properties(
            0).multi_processor_count)
        bound_ms, bound_by, extra = cs.flash_bound(q, bias, dtype, plan["body"])
        row = dict(
            part="flash", kernel="flash_attention", dtype=dtype, B=B, L=L,
            H=H, D=D, padded_keys=tail, earlier_body=earlier_body,
            earlier_ms=sum(ms_earlier) / len(ms_earlier),
            earlier_ms_each=ms_earlier, earlier_max_abs_err=earlier_err,
            plain_ms=cs.time_ms(torch, lambda: flash_attention_reference(
                q, k, v, bias, scale)),
            library_ms=cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias[:, None, None, :])),
            bound_ms=bound_ms, bound_by=bound_by, **extra, tol=TOL[dtype])
        if here:
            row.update(body=plan["body"], padded_dim=plan["padded_dim"],
                       copy_bytes=plan["copy_bytes"],
                       ms=sum(ms_this) / 2, ms_each=ms_this,
                       max_abs_err=max_err(flash_attention(q, k, v, bias),
                                           ref))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def paged_rows(torch, np, make_earlier, here):
    from skycomputing_tpu_torch.ops.paged_attention import (
        kernel_plan,
        paged_attention,
        paged_attention_reference,
        row_plan,
    )

    rows = []
    for ri, (dtype, int8, D) in enumerate(PAGED_ROWS):
        for ci, (name, R, Lq) in enumerate(PAGED_CALLS):
            if D == 64 and WHOLE_ROW_CALLS[dtype, int8] != name:
                continue
            case = cs.attention_case(torch, np, name, R, Lq, dtype,
                                     seed=900 + 2 * ri + ci, int8=int8, D=D)
            args, kw = cs.kernel_args(case)
            ref = paged_attention_reference(*args, **kw)
            earlier_body, earlier = make_earlier(case)
            earlier_err = max_err(earlier(), ref)
            this = (lambda: paged_attention(*args, **kw)) if here else None
            ms_earlier, ms_this = in_turns(torch, earlier, this)
            bound_ms, bound_by = cs.attention_bound(np, case, dtype)
            page_dtype = case["k"].dtype
            row = dict(
                part="paged", kernel=("paged_attention_int8" if int8
                                      else "paged_attention"),
                case=name, dtype=dtype, pages=str(page_dtype).split(".")[-1],
                D=D, R=R, Lq=Lq, H=case["H"], page_size=case["PS"],
                pool_pages=case["P"], table_width=case["table"].shape[1],
                row_bytes=D * page_dtype.itemsize, earlier_body=earlier_body,
                earlier_ms=sum(ms_earlier) / len(ms_earlier),
                earlier_ms_each=ms_earlier, earlier_max_abs_err=earlier_err,
                plain_ms=cs.time_ms(
                    torch, lambda: paged_attention_reference(*args, **kw)),
                library_ms=cs.time_ms(torch, cs.library_call(torch, case)),
                bound_ms=bound_ms, bound_by=bound_by, tol=TOL[dtype])
            if here:
                row.update(body=kernel_plan(case["q"].dtype, page_dtype, Lq, D,
                                            case["PS"]),
                           **row_plan(page_dtype, D), ms=sum(ms_this) / 2,
                           ms_each=ms_this, max_abs_err=max_err(
                               paged_attention(*args, **kw), ref))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="an earlier checkout of the repository")
    parser.add_argument("--part", choices=("before", "ab"), default="ab")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    here = opts.part == "ab"
    libs, nvcc_row = build_all(opts.parent.resolve(), here)
    print(json.dumps(nvcc_row), flush=True)
    ops = opts.parent.resolve() / "skycomputing_tpu_torch" / "ops"
    flash_mod = load_module(ops / "flash_attention.py", "earlier_flash")
    paged_mod = load_module(ops / "paged_attention.py", "earlier_paged")
    earlier = {stem: ctypes.CDLL(str(path))
               for stem, path in libs["earlier"].items()}
    rows = [dict(nvidia_smi=smi, torch=torch.__version__,
                 cuda=torch.version.cuda), nvcc_row]
    rows += flash_rows(torch, np, earlier_flash(
        torch, earlier["flash_attention"], flash_mod), here)
    rows += paged_rows(torch, np, earlier_paged(
        torch, earlier["paged_attention"], paged_mod), here)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"padded_ab_{opts.part}.json").write_text(json.dumps(rows, indent=1))
    bad = [r for r in rows if "tol" in r and max(
        r["earlier_max_abs_err"], r.get("max_abs_err", 0.0)) > r["tol"]]
    for r in bad:
        print(f"FAIL: {r['kernel']} {r['dtype']} D={r['D']} past "
              f"{r['tol']}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
