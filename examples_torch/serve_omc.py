#!/usr/bin/env python3
"""Serve a model with OMC-compressed weights and batched requests (port of
``examples/serve_omc.py``).

Weights live compressed (u16 codes) and are decoded layer by layer inside
each decode step: every block matrix streams its codes through the
``dequant_matmul`` kernel, the embedding rows and the tied head through
``dequantize``.  This is the serving side of the paper's storage model.
The script runs the port's serve CLI on qwen2.5-3b's reduced config with
the reference's arguments; any further arguments are passed on after them
(the CLI takes a flag's last occurrence).

    python3 examples_torch/serve_omc.py                  # on the card
    python3 examples_torch/serve_omc.py --device cpu
    python3 examples_torch/serve_omc.py --wire-roundtrip
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List, Sequence

SRC = Path(__file__).resolve().parents[1] / "src"


def command(extra: Sequence[str] = ()) -> List[str]:
    """The CLI's argument list: the reference's, then ``extra``."""
    return [sys.executable, "-m", "repro_torch.launch.serve",
            "--arch", "qwen2.5-3b", "--smoke", "--batch", "4",
            "--prompt-len", "32", "--gen", "16", "--fmt", "S1E3M7", *extra]


def env() -> dict:
    """This process's environment with the port's ``src`` first on ``PYTHONPATH``."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{path}" if path else str(SRC))


def main(argv: Sequence[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    subprocess.run(command(argv), check=True, env=env())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
