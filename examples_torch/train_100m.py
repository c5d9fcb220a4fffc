#!/usr/bin/env python3
"""End-to-end driver: federated-train a ~100M-parameter model (port of
``examples/train_100m.py``).

The full conformer_s config is the paper's streaming Conformer (17 layers,
d 512, 103,535,104 parameters).  On the card run it with ``--full``
(200 rounds); without it the script trains the reduced config for 30
rounds, as the reference does.  The script runs the port's training CLI
with the reference's arguments (S1E3M7, batch 8, a checkpoint every 10
rounds into ``/tmp/omc_train_100m_torch``); any further arguments are passed
on after them (the CLI takes a flag's last occurrence).  Rerunning the same
command resumes from the latest checkpoint.

    python3 examples_torch/train_100m.py --full          # on the card
    python3 examples_torch/train_100m.py --device cpu --rounds 2 --ckpt-dir DIR
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List, Sequence

SRC = Path(__file__).resolve().parents[1] / "src"


def command(full: bool = False, extra: Sequence[str] = ()) -> List[str]:
    """The CLI's argument list: the reference's, then ``extra``."""
    args = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "conformer_s", "--rounds", "200" if full else "30",
            "--batch", "8", "--fmt", "S1E3M7",
            "--ckpt-dir", "/tmp/omc_train_100m_torch", "--ckpt-every", "10"]
    if not full:
        args.append("--smoke")
    return args + list(extra)


def env() -> dict:
    """This process's environment with the port's ``src`` first on ``PYTHONPATH``."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{path}" if path else str(SRC))


def main(argv: Sequence[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = [a for a in argv if a != "--full"]
    subprocess.run(command("--full" in argv, extra), check=True, env=env())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
