"""KV-cache decoding against full-forward generation (the port of
``tools/bench_kv_cache.py``).

Decodes GPT-2 small both ways from one seeded set of weights — 4
prompts of 32 tokens, ``KV_TOKENS`` (32) new tokens, a context of
``KV_CTX`` (256) — checks that the tokens are identical, and prints ms
per token for each.  ``generate_cached`` runs one prefill over the
prompt, then single-token steps against the cache; ``generate`` runs
the whole stack over the padded context for every token.  The weights
are float32: the tokens are greedy choices over random-weight logits,
whose near-ties bfloat16's rounding can break differently in the two
computation orders.

Usage::

    [KV_TOKENS=32 KV_CTX=256] python -m \\
        skycomputing_tpu_torch.tools.bench_kv_cache [--device cpu]

Prints one JSON line; exit 0 iff the tokens are identical.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..dynamics.estimator import synchronize
from . import add_device_arg, device_record, tool_device

#: the model (GPT-2 small) and the prompts' (batch, length)
GPT = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=12,
           num_attention_heads=12, max_position_embeddings=512,
           dropout_prob=0.0, dtype="float32")
PROMPT = (4, 32)


def run(device, n_new: int, ctx: int) -> dict:
    from ..builder import build_layer_stack
    from ..models.gpt import (
        GptConfig,
        generate,
        generate_cached,
        gpt_layer_configs,
        random_state_dicts,
    )

    cfg = GptConfig(**GPT)
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    stack = build_layer_stack(layer_cfgs)
    for module, sd in zip(stack.layers, random_state_dicts(layer_cfgs, 0)):
        module.load_state_dict(sd, strict=True)
    stack = stack.to(device).eval()
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, PROMPT).astype(np.int32)

    @torch.no_grad()
    def forward(ids):
        return stack(ids.to(device))

    generate_cached(stack, prompt, n_new, ctx)  # warm
    synchronize(device)
    t0 = time.perf_counter()
    out_c = generate_cached(stack, prompt, n_new, ctx)
    synchronize(device)
    tc = time.perf_counter() - t0

    generate(forward, prompt, 2, ctx)  # warm
    synchronize(device)
    t0 = time.perf_counter()
    out_f = generate(forward, prompt, n_new, ctx)
    synchronize(device)
    tf = time.perf_counter() - t0
    return dict(
        identical=bool(np.array_equal(out_c, out_f)),
        new_tokens=n_new, context=ctx, prompts=list(PROMPT),
        cached_ms_per_token=tc / n_new * 1e3,
        full_ms_per_token=tf / n_new * 1e3,
        speedup=tf / tc,
        device=device_record(device),
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = tool_device(args)
    out = run(device, int(os.getenv("KV_TOKENS", "32")),
              int(os.getenv("KV_CTX", "256")))
    print(json.dumps(out), flush=True)
    print(f"# cached {out['cached_ms_per_token']:.2f} ms/token | full "
          f"{out['full_ms_per_token']:.2f} ms/token | identical "
          f"{out['identical']} | speedup {out['speedup']:.1f}x on "
          f"{out['device']['kind']}", flush=True)
    return 0 if out["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
