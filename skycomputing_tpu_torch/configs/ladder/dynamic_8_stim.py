"""Ladder config 3: dynamic allocation, 8 workers, stimulated heterogeneity.

The port's copy of ``experiment/configs/dynamic_8_stim.py``, over the port's
launcher config; run with ``python -m skycomputing_tpu_torch.launch -c
skycomputing_tpu_torch/configs/ladder/dynamic_8_stim.py`` or through
``python -m skycomputing_tpu_torch.tools.run_ladder``.
"""

import os

os.environ["SKYTPU_ALLOCATE_TYPE"] = "dynamic"
os.environ["SKYTPU_CORE_NUM"] = "8"
os.environ["SKYTPU_LAYER_NUM"] = "10"
os.environ.setdefault("SKYTPU_PRESET", "large")
os.environ.setdefault("STIMULATE", "1")

base = "../bert_pipeline.py"
