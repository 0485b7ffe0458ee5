"""Ladder config 4: 96-layer stacked BERT, optimal allocation, 32 workers.

The port's copy of ``experiment/configs/optimal_32_96layer.py``, over the port's
launcher config; run with ``python -m skycomputing_tpu_torch.launch -c
skycomputing_tpu_torch/configs/ladder/optimal_32_96layer.py`` or through
``python -m skycomputing_tpu_torch.tools.run_ladder``.
"""

import os

os.environ["SKYTPU_ALLOCATE_TYPE"] = "optimal"
os.environ["SKYTPU_CORE_NUM"] = "32"
os.environ["SKYTPU_LAYER_NUM"] = "31"  # 93 encoder units + ends ~ 96 layers
os.environ.setdefault("SKYTPU_PRESET", "large")

base = "../bert_pipeline.py"
