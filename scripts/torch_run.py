"""Thin shim: the PyTorch port's command line lives in
``cbinfer_tpu_torch.cli`` (console script ``cbinfer-torch``); this path
keeps ``python scripts/torch_run.py`` working, as ``scripts/run.py`` does
for the JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cbinfer_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
