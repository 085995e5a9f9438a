"""Unified CLI: ``python -m arap_flow_tpu_torch <command> [args...]``.

Commands: deform (arap_deform), warp (warp_image).
"""

import importlib
import sys

COMMANDS = {
    "deform": ("arap_flow_tpu_torch.pipeline.deform_tool", "main"),
    "warp": ("arap_flow_tpu_torch.pipeline.warp_tool", "main"),
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m arap_flow_tpu_torch <command> [args...]")
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    mod, fn = COMMANDS[argv[0]]
    return getattr(importlib.import_module(mod), fn)(argv[1:]) or 0


if __name__ == "__main__":
    raise SystemExit(main())
