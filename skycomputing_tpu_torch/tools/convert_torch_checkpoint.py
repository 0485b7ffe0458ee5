"""Convert a reference (``scaelum``) whole-model checkpoint to the port's
checkpoint (the port of ``tools/convert_torch_checkpoint.py``).

    python -m skycomputing_tpu_torch.tools.convert_torch_checkpoint \\
        --checkpoint epoch_1.pth --out build/epoch_1.pt \\
        [--preset large] [--layer-num 10] [--num-classes 3]

The layer-config list is rebuilt from the knobs the reference
experiment used (``--layer-num`` encoder trios of a BERT preset); the
output, ``{"layers": [per-layer state dicts]}``, is what
``ParameterServer.save_weights_to_file`` writes, and loads with
``ParameterServer.load_weights_from_file`` under any allocation.  The
conversion moves tensors between dicts on the CPU and uses no device,
so the tool takes no ``--device``.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--preset", default="large")
    parser.add_argument("--layer-num", type=int, default=10)
    parser.add_argument("--num-classes", type=int, default=3)
    args = parser.parse_args(argv)

    from ..models import bert_config, bert_layer_configs
    from ..utils import atomic_torch_save
    from ..utils.torch_convert import convert_torch_checkpoint

    model_cfg = bert_layer_configs(
        bert_config(args.preset), num_encoder_units=args.layer_num,
        num_classes=args.num_classes)
    layers = convert_torch_checkpoint(args.checkpoint, model_cfg)
    parent = os.path.dirname(args.out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    atomic_torch_save({"layers": layers}, args.out)
    print(f"converted {len(layers)} layers -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
