"""Stage-3 CLI — train the stage-2 style translator for one uid (PyTorch
port of ``drawingspinup_tpu/cli/train_stage2.py``: the same flags, plus
``--device`` and ``--seed``)."""
from __future__ import annotations

from drawingspinup_torch.cli import train_stage1


def main(argv=None) -> int:
    return train_stage1.run(2, argv, __doc__)


if __name__ == "__main__":
    raise SystemExit(main())
