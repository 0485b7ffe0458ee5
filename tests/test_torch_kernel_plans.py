"""Which body of each hand-written kernel serves a call, decided on the
host from dtypes and shapes alone (so it is checked here, on the CPU),
and the build's ``ptxas -v`` report as the port reads it.  The bodies
themselves run only on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from skycomputing_tpu_torch.ops._build import parse_ptxas
from skycomputing_tpu_torch.ops.flash_attention import (
    kernel_plan as flash_kernel_plan,
)
from skycomputing_tpu_torch.ops.paged_attention import (
    kernel_plan as paged_kernel_plan,
)

pytestmark = pytest.mark.torch_port

H100_SMS = 132


@pytest.mark.parametrize("dtype, D, body", [
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 40, "cuda_core"),  # not a multiple of 16
    (torch.float32, 64, "cuda_core"),  # exact float32 arithmetic
    (torch.float32, 128, "cuda_core"),
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


@pytest.mark.parametrize("page_dtype, Lq, D, body", [
    (torch.bfloat16, 1, 64, "decode"),  # a decode tick
    (torch.bfloat16, 5, 64, "decode"),  # speculative verify, k = 4
    (torch.int8, 1, 64, "decode"),
    (torch.int8, 16, 128, "decode"),
    (torch.float32, 16, 128, "decode"),
    (torch.bfloat16, 17, 64, "query_tile"),  # a prefill wave
    (torch.int8, 128, 64, "query_tile"),
    (torch.int8, 1, 40, "query_tile"),  # a 40-byte row
    (torch.bfloat16, 1, 40, "decode"),  # an 80-byte row: five chunks
])
def test_paged_body_depends_on_lq_head_dim_and_page_type(page_dtype, Lq, D,
                                                          body):
    assert paged_kernel_plan(page_dtype, Lq, D) == body


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
