"""Ladder config 2: BERT-large MNLI, optimal allocation, 8 workers.

The port's copy of ``experiment/configs/optimal_8.py``, over the port's
launcher config; run with ``python -m skycomputing_tpu_torch.launch -c
skycomputing_tpu_torch/configs/ladder/optimal_8.py`` or through
``python -m skycomputing_tpu_torch.tools.run_ladder``.
"""

import os

os.environ["SKYTPU_ALLOCATE_TYPE"] = "optimal"
os.environ["SKYTPU_CORE_NUM"] = "8"
os.environ["SKYTPU_LAYER_NUM"] = "10"
os.environ.setdefault("SKYTPU_PRESET", "large")

base = "../bert_pipeline.py"
