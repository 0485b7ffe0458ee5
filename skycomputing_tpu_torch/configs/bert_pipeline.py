"""The launcher's experiment config (the port of ``experiment/config.py``):
BERT-large fine-tuned on MNLI with SGD over a pool of pipeline workers.
The data is ``GlueDataset``'s MNLI train split read from
``SKYTPU_GLUE_DIR`` (``train.tsv``, ``dev_matched.tsv``) with the
WordPiece vocabulary ``SKYTPU_VOCAB_FILE``; where either is unset or
missing, its seeded synthetic corpus (512 class-conditional rows of
lengths 8 to ``SKYTPU_SEQ_LEN``, zero-padded), as the JAX config does.

Environment overrides (all optional):

- ``SKYTPU_GLUE_DIR`` / ``SKYTPU_VOCAB_FILE``: the MNLI directory and
  the vocabulary (the synthetic corpus when unset)

- ``SKYTPU_ALLOCATE_TYPE``: even | optimal | dynamic (default even)
- ``SKYTPU_CORE_NUM``: number of pipeline workers (4)
- ``SKYTPU_LAYER_NUM``: encoder layers, each 3 units (10)
- ``SKYTPU_PRESET``: BERT preset, tiny | base | large (large)
- ``SKYTPU_BATCH_SIZE`` (32) / ``SKYTPU_SEQ_LEN`` (128) /
  ``SKYTPU_MICROBATCHES`` (1) / ``SKYTPU_MAX_ITERS`` (30) /
  ``SKYTPU_MAX_EPOCHS`` (1)
- ``SKYTPU_SCHEDULE``: gpipe | 1f1b
- ``SKYTPU_FLASH``: 1 routes attention through the flash kernel (B1);
  the kernel has no dropout, so attention dropout is then 0
- ``SKYTPU_PROFILE``: static | timed — the model profile the optimal
  and dynamic allocations read (FLOPs, or measured seconds per unit)
- ``SKYTPU_OPTIM`` (sgd) / ``SKYTPU_LR`` (0.001): an optax name and rate
- ``SKYTPU_CKPT_DIR``: where a ``CheckpointHook`` saves at the end of
  each epoch and of the run (no checkpoint when unset)
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
from skycomputing_tpu_torch.models import bert_config, bert_layer_configs

ALLOCATE_TYPE = os.getenv("SKYTPU_ALLOCATE_TYPE", "even")
CORE_NUM = int(os.getenv("SKYTPU_CORE_NUM", "4"))
LAYER_NUM = int(os.getenv("SKYTPU_LAYER_NUM", "10"))
PRESET = os.getenv("SKYTPU_PRESET", "large")
BATCH_SIZE = int(os.getenv("SKYTPU_BATCH_SIZE", "32"))
MAX_SEQ_LENGTH = int(os.getenv("SKYTPU_SEQ_LEN", "128"))
NUM_MICROBATCHES = int(os.getenv("SKYTPU_MICROBATCHES", "1"))
SCHEDULE = os.getenv("SKYTPU_SCHEDULE", "gpipe")
MAX_ITERS = int(os.getenv("SKYTPU_MAX_ITERS", "30"))
FLASH = os.getenv("SKYTPU_FLASH", "0") == "1"

__flash = dict(use_flash_attention=True,
               attention_probs_dropout_prob=0.0) if FLASH else {}
__bert_cfg = bert_config(PRESET, **__flash)

# 1 embeddings + LAYER_NUM x (head, body, tail) + pooler + classifier
model_config = bert_layer_configs(__bert_cfg, num_encoder_units=LAYER_NUM,
                                  num_classes=3)

__LOG_ROOT = osp.join(
    os.getenv("SKYTPU_LOG_ROOT", "logs"),
    f"{CORE_NUM}nodes_{LAYER_NUM}layers",
    ALLOCATE_TYPE,
)
logging_config = dict(filename=osp.join(__LOG_ROOT, "allocation.log"))

# worker pool: logical stages round-robined over the cards
worker_config = __worker_pool_config(CORE_NUM)

data_config = dict(
    dataset_cfg=dict(
        type="GlueDataset",
        data_dir=os.getenv("SKYTPU_GLUE_DIR", ""),
        vocab_file=os.getenv("SKYTPU_VOCAB_FILE", None),
        max_seq_length=MAX_SEQ_LENGTH,
        do_lower_case=False,
        processor="mnli",
    ),
    dataloader_cfg=dict(batch_size=BATCH_SIZE, shuffle=True),
)

allocator_config = dict(
    type=ALLOCATE_TYPE,
    benchmark_config=dict(
        model=dict(
            param_scale=2,
            timed=os.getenv("SKYTPU_PROFILE", "static") == "timed",
            data_generator_cfg=dict(
                generator_type="RandomTokenGenerator",
                generator_cfg=dict(
                    batch_size=BATCH_SIZE,
                    seq_length=MAX_SEQ_LENGTH,
                    vocab_size=__bert_cfg.vocab_size,
                ),
            ),
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
if os.getenv("SKYTPU_CKPT_DIR"):
    __hooks.append(dict(type="CheckpointHook",
                        save_path=os.environ["SKYTPU_CKPT_DIR"],
                        save_interval=1))

train_config = dict(
    optim_cfg=dict(
        optim_type=os.getenv("SKYTPU_OPTIM", "sgd"),
        learning_rate=float(os.getenv("SKYTPU_LR", "0.001")),
    ),
    loss_cfg=dict(type="CrossEntropyLoss"),
    runner_cfg=dict(
        max_epochs=int(os.getenv("SKYTPU_MAX_EPOCHS", "1")),
        max_iters=MAX_ITERS,
    ),
    hook_config=__hooks,
    timer_config=dict(root=__LOG_ROOT),
)
