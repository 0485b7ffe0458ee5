"""The launcher's experiment config (the port of ``experiment/config.py``):
BERT-large fine-tuned on MNLI with SGD over a pool of pipeline workers,
or under ``SKYTPU_MODEL=gpt`` a causal-LM GPT at the BERT preset's
width.  BERT's data is ``GlueDataset``'s MNLI train split read from
``SKYTPU_GLUE_DIR`` (``train.tsv``, ``dev_matched.tsv``) with the
WordPiece vocabulary ``SKYTPU_VOCAB_FILE``; where either is unset or
missing, its seeded synthetic corpus (512 class-conditional rows of
lengths 8 to ``SKYTPU_SEQ_LEN``, zero-padded), as the JAX config does.
GPT's is ``RandomLmDataset`` (seeded n-gram rows over GPT-2's 50,257
tokens), profiled through a ``DataloaderGenerator`` probe of the same
loader and trained with ``CausalLmLoss``, as the JAX config does.

Environment overrides (all optional):

- ``SKYTPU_MODEL``: bert (MNLI classification) | gpt (causal LM:
  ``SKYTPU_LAYER_NUM`` transformer blocks of the preset's hidden size,
  heads and dtype; any other value means bert)
- ``SKYTPU_GLUE_DIR`` / ``SKYTPU_VOCAB_FILE``: the MNLI directory and
  the vocabulary (the synthetic corpus when unset)

- ``SKYTPU_ALLOCATE_TYPE``: even | optimal | dynamic (default even)
- ``SKYTPU_CORE_NUM``: number of pipeline workers (4)
- ``SKYTPU_LAYER_NUM``: encoder layers, each 3 units, or GPT blocks,
  each 2 units (10)
- ``SKYTPU_PRESET``: BERT preset, tiny | base | large (large)
- ``SKYTPU_BATCH_SIZE`` (32) / ``SKYTPU_SEQ_LEN`` (128) /
  ``SKYTPU_MICROBATCHES`` (1) / ``SKYTPU_MAX_ITERS`` (30) /
  ``SKYTPU_MAX_EPOCHS`` (1)
- ``SKYTPU_SCHEDULE``: gpipe | 1f1b
- ``SKYTPU_FLASH``: 1 routes BERT's attention through the flash kernel
  (B1); the kernel has no dropout, so attention dropout is then 0 (GPT
  has no flash path, as in JAX)
- ``SKYTPU_PROFILE``: static | timed — the model profile the optimal
  and dynamic allocations read (FLOPs, or measured seconds per unit)
- ``SKYTPU_OPTIM`` (sgd) / ``SKYTPU_LR`` (0.001): an optax name and rate
- ``SKYTPU_CKPT_DIR``: where a ``CheckpointHook`` saves at the end of
  each epoch and of the run (no checkpoint when unset)
- ``SKYTPU_KERNEL_LAUNCHES``: 1 registers ``KernelLaunchHook``, which
  logs the flash kernel's launches by body after each step (set by
  ``tools/run_ladder`` for its rungs)
- ``SKYTPU_LOG_ROOT``: the log directory's root (logs)
- ``STIMULATE``: the seeded heterogeneity stimulator skews the device
  profile (read by the device benchmarker)
"""

import os
import os.path as osp

from skycomputing_tpu_torch.dynamics.benchmarker import (
    PROXY_INPUT_SIZE as __PROXY_INPUT_SIZE,
    PROXY_MODEL_CONFIG as __PROXY_MODEL_CONFIG,
)
from skycomputing_tpu_torch.dynamics.worker_manager import (
    worker_pool_config as __worker_pool_config,
)
from skycomputing_tpu_torch.models import (
    GptConfig,
    bert_config,
    bert_layer_configs,
    gpt_layer_configs,
)

ALLOCATE_TYPE = os.getenv("SKYTPU_ALLOCATE_TYPE", "even")
CORE_NUM = int(os.getenv("SKYTPU_CORE_NUM", "4"))
LAYER_NUM = int(os.getenv("SKYTPU_LAYER_NUM", "10"))
PRESET = os.getenv("SKYTPU_PRESET", "large")
BATCH_SIZE = int(os.getenv("SKYTPU_BATCH_SIZE", "32"))
MAX_SEQ_LENGTH = int(os.getenv("SKYTPU_SEQ_LEN", "128"))
NUM_MICROBATCHES = int(os.getenv("SKYTPU_MICROBATCHES", "1"))
SCHEDULE = os.getenv("SKYTPU_SCHEDULE", "gpipe")
MODEL = os.getenv("SKYTPU_MODEL", "bert")
MAX_ITERS = int(os.getenv("SKYTPU_MAX_ITERS", "30"))
FLASH = os.getenv("SKYTPU_FLASH", "0") == "1"

__flash = dict(use_flash_attention=True,
               attention_probs_dropout_prob=0.0) if FLASH else {}
__bert_cfg = bert_config(PRESET, **__flash)

if MODEL == "gpt":
    # embeddings + LAYER_NUM x (attention, MLP) + LM head
    __gpt_cfg = GptConfig(
        hidden_size=__bert_cfg.hidden_size,
        num_attention_heads=__bert_cfg.num_attention_heads,
        num_hidden_layers=LAYER_NUM,
        max_position_embeddings=MAX_SEQ_LENGTH,
        dtype=__bert_cfg.dtype,
    )
    model_config = gpt_layer_configs(__gpt_cfg, num_blocks=LAYER_NUM)
else:
    # 1 embeddings + LAYER_NUM x (head, body, tail) + pooler + classifier
    model_config = bert_layer_configs(
        __bert_cfg, num_encoder_units=LAYER_NUM, num_classes=3)

__LOG_ROOT = osp.join(
    os.getenv("SKYTPU_LOG_ROOT", "logs"),
    f"{CORE_NUM}nodes_{LAYER_NUM}layers",
    ALLOCATE_TYPE,
)
logging_config = dict(filename=osp.join(__LOG_ROOT, "allocation.log"))

# worker pool: logical stages round-robined over the cards
worker_config = __worker_pool_config(CORE_NUM)

if MODEL == "gpt":
    __dataset_cfg = dict(type="RandomLmDataset", seq_length=MAX_SEQ_LENGTH,
                         vocab_size=50257)
else:
    __dataset_cfg = dict(
        type="GlueDataset",
        data_dir=os.getenv("SKYTPU_GLUE_DIR", ""),
        vocab_file=os.getenv("SKYTPU_VOCAB_FILE", None),
        max_seq_length=MAX_SEQ_LENGTH,
        do_lower_case=False,
        processor="mnli",
    )
data_config = dict(
    dataset_cfg=__dataset_cfg,
    dataloader_cfg=dict(batch_size=BATCH_SIZE, shuffle=True),
)

# the model profiler's probe takes the model family's inputs: GPT's the
# loader's first (input_ids,) batch, BERT's random token triples
if MODEL == "gpt":
    __model_probe_cfg = dict(
        generator_type="DataloaderGenerator",
        generator_cfg=dict(generator_cfg=data_config),
    )
else:
    __model_probe_cfg = dict(
        generator_type="RandomTokenGenerator",
        generator_cfg=dict(
            batch_size=BATCH_SIZE,
            seq_length=MAX_SEQ_LENGTH,
            vocab_size=__bert_cfg.vocab_size,
        ),
    )

allocator_config = dict(
    type=ALLOCATE_TYPE,
    benchmark_config=dict(
        model=dict(
            param_scale=2,
            timed=os.getenv("SKYTPU_PROFILE", "static") == "timed",
            data_generator_cfg=__model_probe_cfg,
        ),
        device=dict(
            # a tensor-core-saturating product chain as the speed proxy
            model_config=__PROXY_MODEL_CONFIG,
            iterations=10,
            data_generator_cfg=dict(
                generator_type="RandomTensorGenerator",
                generator_cfg=dict(size=__PROXY_INPUT_SIZE),
            ),
        ),
    ),
)

__hooks = [
    dict(type="StopHook", root=__LOG_ROOT),
    dict(type="DistributedTimerHelperHook"),
]
if os.getenv("SKYTPU_KERNEL_LAUNCHES") == "1":
    __hooks.append(dict(type="KernelLaunchHook"))
if os.getenv("SKYTPU_CKPT_DIR"):
    __hooks.append(dict(type="CheckpointHook",
                        save_path=os.environ["SKYTPU_CKPT_DIR"],
                        save_interval=1))

train_config = dict(
    optim_cfg=dict(
        optim_type=os.getenv("SKYTPU_OPTIM", "sgd"),
        learning_rate=float(os.getenv("SKYTPU_LR", "0.001")),
    ),
    loss_cfg=dict(
        type="CausalLmLoss" if MODEL == "gpt" else "CrossEntropyLoss"),
    runner_cfg=dict(
        max_epochs=int(os.getenv("SKYTPU_MAX_EPOCHS", "1")),
        max_iters=MAX_ITERS,
    ),
    hook_config=__hooks,
    timer_config=dict(root=__LOG_ROOT),
)
