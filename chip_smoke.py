"""The port's card check on one NVIDIA GPU: every ``cuda``-marked test of
tests/test_torch_*.py (kernels against their plain versions, the solve
paths, the pipelines and entry points), in one pytest process.

    python3 chip_smoke.py

Exits with pytest's code (1 without a card); the last line is the JSON
device record. One file alone: ``python3 -m pytest -m cuda FILE``.
"""

import json
import os
import pathlib
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_files() -> list[pathlib.Path]:
    """The test files that hold card tests; none imports jax or PIL."""
    files = sorted(pathlib.Path(ROOT, "tests").glob("test_torch_*.py"))
    return [f for f in files if "@pytest.mark.cuda" in f.read_text()]


def main() -> int:
    rc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                         "-p", "no:cacheprovider", *card_files()],
                        cwd=ROOT).returncode
    import torch

    dev = torch.cuda.is_available()
    print(json.dumps({"ok": dev and rc == 0, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()} if dev else None}))
    return rc if dev else 1


if __name__ == "__main__":
    raise SystemExit(main())
