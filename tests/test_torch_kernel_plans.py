"""Which body of each hand-written kernel serves a call, decided on the
host from dtypes and shapes alone (so it is checked here, on the CPU),
and the build's ``ptxas -v`` report as the port reads it.  The bodies
themselves run only on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from skycomputing_tpu_torch.ops._build import CSRC, parse_ptxas
from skycomputing_tpu_torch.ops.flash_attention import (
    copy_granule,
)
from skycomputing_tpu_torch.ops.flash_attention import (
    kernel_plan as flash_kernel_plan,
)
from skycomputing_tpu_torch.ops.paged_attention import (
    kernel_plan as paged_kernel_plan,
)
from skycomputing_tpu_torch.ops.paged_attention import row_plan

pytestmark = pytest.mark.torch_port

H100_SMS = 132


@pytest.mark.parametrize("dtype, D, body", [
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 40, "tensor_core"),  # staged at 48, its pad zero
    # float32: 3xTF32 tensor-core products at every head_dim
    (torch.float32, 64, "tensor_core_f32"),
    (torch.float32, 128, "tensor_core_f32"),
    (torch.float32, 40, "tensor_core_f32"),
    (torch.float32, 36, "tensor_core_f32"),  # staged at 40
])
def test_flash_body_depends_on_dtype_and_head_dim(dtype, D, body):
    for B, L in ((8, 128), (1, 7), (2, 1000)):
        assert flash_kernel_plan(dtype, B, L, 16, D, H100_SMS)["body"] == body


@pytest.mark.parametrize("B, L, H, warps", [
    (8, 128, 16, 4),  # BERT-large's microbatch: 256 blocks of 64 queries
    (2, 512, 16, 4),
    (2, 100, 16, 1),  # 64 blocks of 64 would leave half the card idle
    (1, 7, 4, 1),
])
def test_flash_tensor_core_blocks_fill_the_card(B, L, H, warps):
    plan = flash_kernel_plan(torch.bfloat16, B, L, H, 64, H100_SMS)
    assert plan["warps"] == warps and plan["q_tile"] == 16 * warps
    blocks = -(-L // plan["q_tile"]) * H * B
    assert blocks >= H100_SMS or warps == 1


@pytest.mark.parametrize("B, L, H, warps", [
    (4, 128, 16, 2),  # the dp shard of phases 27-28: 256 blocks of 32
    (8, 128, 16, 4),
    (1, 4096, 16, 4),  # long BERT's single-device baseline
    (2, 100, 16, 1),
])
def test_flash_float32_tensor_core_blocks_fill_the_card(B, L, H, warps):
    """The float32 tensor-core body takes the bfloat16 body's rule for
    warps."""
    plan = flash_kernel_plan(torch.float32, B, L, H, 64, H100_SMS)
    assert plan == dict(body="tensor_core_f32", warps=warps,
                        q_tile=16 * warps, padded_dim=64, copy_bytes=16)
    assert plan == dict(flash_kernel_plan(torch.bfloat16, B, L, H, 64,
                                          H100_SMS), body="tensor_core_f32")
    blocks = -(-L // plan["q_tile"]) * H * B
    assert blocks >= H100_SMS or warps == 1


@pytest.mark.parametrize("q_dtype, page_dtype, Lq, D, page_size, body", [
    (torch.bfloat16, torch.bfloat16, 1, 64, 16, "decode"),  # a decode tick
    (torch.bfloat16, torch.bfloat16, 5, 64, 16, "decode"),  # verify, k = 4
    (torch.bfloat16, torch.int8, 1, 64, 16, "decode"),
    (torch.bfloat16, torch.int8, 16, 128, 16, "decode"),
    (torch.float32, torch.float32, 16, 128, 16, "decode"),
    (torch.float32, torch.int8, 1, 40, 16, "decode"),  # a 40-byte row
    (torch.bfloat16, torch.bfloat16, 1, 40, 16, "decode"),  # 80 bytes
    # prefill waves: bfloat16 q with head_dim and page size multiples of
    # 16 take the tensor-core body, over fp and int8 pages alike
    (torch.bfloat16, torch.bfloat16, 17, 64, 16, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 128, 64, 16, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 256, 64, 16, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 17, 128, 16, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 128, 128, 16, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 256, 128, 16, "tensor_core"),
    (torch.bfloat16, torch.int8, 17, 64, 16, "tensor_core"),
    (torch.bfloat16, torch.int8, 128, 64, 16, "tensor_core"),
    (torch.bfloat16, torch.int8, 256, 128, 16, "tensor_core"),
    (torch.bfloat16, torch.bfloat16, 128, 64, 32, "tensor_core"),
    # float32 prefill and chunk waves take the register-tile body (every
    # product a float32 FMA), over fp and int8 pages alike
    (torch.float32, torch.float32, 128, 64, 16, "register_tile"),
    (torch.float32, torch.int8, 128, 64, 16, "register_tile"),
    (torch.float32, torch.float32, 17, 64, 16, "register_tile"),
    # pages of 4 and 8 (the JAX tests') and head_dim 40 in bf16 too: the
    # tensor-core body does not take them, their rows are whole chunks
    (torch.bfloat16, torch.bfloat16, 128, 64, 4, "register_tile"),
    (torch.bfloat16, torch.int8, 24, 64, 8, "register_tile"),
    (torch.bfloat16, torch.bfloat16, 128, 40, 16, "register_tile"),
    (torch.float32, torch.float32, 256, 128, 16, "register_tile"),
    (torch.float32, torch.float32, 64, 12, 4, "register_tile"),  # 48 bytes
    # a K/V row that is not whole 16-byte chunks is staged padded by the
    # register-tile body: int8 at head_dim 40 (40 bytes), float32 at 30
    # (120 bytes)
    (torch.float32, torch.int8, 128, 40, 16, "register_tile"),
    (torch.bfloat16, torch.int8, 17, 40, 8, "register_tile"),
    (torch.float32, torch.float32, 32, 30, 16, "register_tile"),
    (torch.bfloat16, torch.bfloat16, 64, 20, 4, "register_tile"),  # 40 B
])
def test_paged_body_depends_on_lq_head_dim_and_page_type(
        q_dtype, page_dtype, Lq, D, page_size, body):
    assert paged_kernel_plan(q_dtype, page_dtype, Lq, D, page_size) == body


@pytest.mark.parametrize("Lq", [17, 32, 33, 64, 128, 256])
@pytest.mark.parametrize("page_dtype", ["float32", "int8"])
def test_paged_float32_prefill_takes_the_register_tile_body(page_dtype, Lq):
    """Every float32 prefill and chunk bucket of the serving bench (GPT-2's
    head_dim 64, pages of 16) over fp and int8 pages takes the
    register-tile body, whose block is 4 warps over 32 queries (16 past
    head_dim 64)."""
    dtype = getattr(torch, page_dtype)
    assert paged_kernel_plan(torch.float32, dtype, Lq, 64,
                             16) == "register_tile"
    source = (CSRC / "paged_attention.cu").read_text()
    assert "constexpr int kTileWarps = 4;" in source
    assert "return d_max > 64 ? 16 : 32;" in source


@pytest.mark.parametrize("Lq", [17, 32, 64, 128, 256])
def test_paged_tensor_core_blocks_take_four_warps(Lq):
    """Every prefill and chunk bucket takes the tensor-core body, whose
    block is a constant 4 warps of 16 queries (4 beat 1 and 2 on the
    card at Lq 32, 64, 128 and 256: the walk of a block, not the number
    of blocks, sets the time; ``prefill_ab.py`` times them)."""
    for page_dtype in (torch.bfloat16, torch.int8):
        assert paged_kernel_plan(torch.bfloat16, page_dtype, Lq, 64,
                                 16) == "tensor_core"
    source = (CSRC / "paged_attention.cu").read_text()
    assert "constexpr int kMmaWarps = 4;" in source
    assert "constexpr int kMmaQTile = kMmaWarps * kMmaRows;" in source


def _widest_power_of_two_dividing(n):
    return max(g for g in (1, 2, 4, 8, 16) if n % g == 0)


@pytest.mark.parametrize("dtype, body, step", [
    (torch.bfloat16, "tensor_core", 16), (torch.float32, "tensor_core_f32", 8),
])
def test_flash_plan_pads_every_head_dim_onto_a_tensor_core_body(dtype, body,
                                                                step):
    """Every head_dim 1..128 takes its dtype's tensor-core body, staged at
    the head_dim rounded up to the mma's k-step (the body instantiated
    for it) and copied in the widest granule that divides a row's bytes
    (cp.async at 4 bytes and up; a bf16 row of odd head_dim by 2-byte
    loads)."""
    for D in range(1, 129):
        plan = flash_kernel_plan(dtype, 4, 128, 16, D, H100_SMS)
        row = D * dtype.itemsize
        assert plan["body"] == body
        assert plan["padded_dim"] % step == 0
        assert D <= plan["padded_dim"] < D + step
        assert plan["copy_bytes"] == _widest_power_of_two_dividing(row)
        assert plan["copy_bytes"] >= (2 if dtype == torch.bfloat16 else 4)
    with pytest.raises(ValueError, match="head_dim 129"):
        flash_kernel_plan(dtype, 4, 128, 16, 129, H100_SMS)


@pytest.mark.parametrize("q_dtype, page_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.int8), (torch.bfloat16, torch.int8),
])
def test_paged_plan_takes_every_head_dim_and_page_type(q_dtype, page_dtype):
    """Every head_dim 1..128 over every page type, at each of the bodies'
    edges of Lq and over pages of 4, 8 and 16, takes the decode, the
    tensor-core or the register-tile body; the decode and register-tile
    bodies stage a K/V row padded to whole 16-byte slots and copy it in
    the widest granule that divides its bytes (cp.async at 4 bytes and
    up, ordinary loads below), and the tensor-core body's rows are whole
    16-byte chunks."""
    size = page_dtype.itemsize
    for D in range(1, 129):
        row = row_plan(page_dtype, D)
        assert row["padded_dim"] * size % 16 == 0
        assert D <= row["padded_dim"] < D + 16 // size
        assert row["copy_bytes"] == _widest_power_of_two_dividing(D * size)
        assert row["copy_bytes"] == copy_granule(D * size)
        for Lq in (1, 8, 16, 17, 128):
            for page_size in (4, 8, 16):
                body = paged_kernel_plan(q_dtype, page_dtype, Lq, D,
                                         page_size)
                if Lq <= 16:
                    assert body == "decode"
                elif (q_dtype == torch.bfloat16 and D % 16 == 0
                      and page_size % 16 == 0):
                    assert body == "tensor_core"
                    assert row["padded_dim"] == D and row["copy_bytes"] == 16
                else:
                    assert body == "register_tile"


def test_parse_ptxas_reads_each_kernel():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 131 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 2048 bytes smem
"""
    assert parse_ptxas(text) == {
        "_Z3fooPf": dict(stack_bytes=0, spill_store_bytes=0,
                         spill_load_bytes=0, registers=131),
        "_Z3barPf": dict(stack_bytes=8, spill_store_bytes=12,
                         spill_load_bytes=16, registers=255,
                         static_smem_bytes=2048),
    }


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every ``csrc/*.cuh`` header
    beside it, so an edited shared header rebuilds each source."""
    from skycomputing_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
