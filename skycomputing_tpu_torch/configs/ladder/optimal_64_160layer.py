"""Ladder config 5: 160-layer stacked BERT, optimal allocation, 64 workers
(the paper-repro scale; compare against even with --allocate-type even).

The port's copy of ``experiment/configs/optimal_64_160layer.py``, over the port's
launcher config; run with ``python -m skycomputing_tpu_torch.launch -c
skycomputing_tpu_torch/configs/ladder/optimal_64_160layer.py`` or through
``python -m skycomputing_tpu_torch.tools.run_ladder``.
"""

import os

os.environ["SKYTPU_ALLOCATE_TYPE"] = "optimal"
os.environ["SKYTPU_CORE_NUM"] = "64"
os.environ["SKYTPU_LAYER_NUM"] = "53"  # 159 encoder units + ends ~ 160 layers
os.environ.setdefault("SKYTPU_PRESET", "large")
os.environ.setdefault("STIMULATE", "1")

base = "../bert_pipeline.py"
