"""Ladder config 1: BERT-large MNLI, even allocation, 4 workers.

The port's copy of ``experiment/configs/even_4.py``, over the port's
launcher config; run with ``python -m skycomputing_tpu_torch.launch -c
skycomputing_tpu_torch/configs/ladder/even_4.py`` or through
``python -m skycomputing_tpu_torch.tools.run_ladder``.
"""

import os

os.environ["SKYTPU_ALLOCATE_TYPE"] = "even"
os.environ["SKYTPU_CORE_NUM"] = "4"
os.environ["SKYTPU_LAYER_NUM"] = "10"
os.environ.setdefault("SKYTPU_PRESET", "large")

base = "../bert_pipeline.py"
