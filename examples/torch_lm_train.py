"""End-to-end LM training driver example (~100M-class model; port of
``examples/lm_train.py``).

Trains xlstm-125m at reduced width for a few hundred steps with the
production trainer (checkpointing, auto-resume, watchdog) on the card;
add ``--device cpu`` for the host.  Swap ``--arch`` for any of the 10
assigned architectures.  Without arguments the checkpoints go to a fresh
temporary directory; with arguments they go where ``--ckpt-dir`` says.

  PYTHONPATH=src python examples/torch_lm_train.py
  PYTHONPATH=src python examples/torch_lm_train.py --device cpu \\
      --arch qwen2-0.5b --steps 100
"""

import sys
import tempfile

from repro_torch.launch import train

DEFAULTS = ["--arch", "xlstm-125m", "--steps", "200", "--batch", "8",
            "--seq", "256"]


def main(argv=None):
    """The trainer on ``argv`` (the defaults, plus any ``--device``, when
    ``argv`` names no arch), checkpointing to a temporary directory unless
    ``argv`` gives ``--ckpt-dir``; its ``TrainRun``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv = DEFAULTS + argv
    if "--ckpt-dir" in argv:
        return train.main(argv)
    with tempfile.TemporaryDirectory(prefix="repro_lm_ckpt-") as d:
        return train.main(argv + ["--ckpt-dir", d])


if __name__ == "__main__":
    main()
