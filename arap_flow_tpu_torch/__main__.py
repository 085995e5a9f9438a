"""Unified CLI: ``python -m arap_flow_tpu_torch <command> [args...]``.

Commands: para_gen (dataset generation), generate (phase by phase),
run_arap (batch deform over path lists), run_warp (batch warp), deform
(arap_deform), warp (warp_image), texture_gen (procedural textures),
dmo_gen (textured-mask datasets).
"""

import importlib
import sys

COMMANDS = {
    "para_gen": ("arap_flow_tpu_torch.pipeline.para_gen", "main"),
    "generate": ("arap_flow_tpu_torch.pipeline.generate", "main"),
    "run_arap": ("arap_flow_tpu_torch.pipeline.run_arap", "main"),
    "run_warp": ("arap_flow_tpu_torch.pipeline.run_warp", "main"),
    "deform": ("arap_flow_tpu_torch.pipeline.deform_tool", "main"),
    "warp": ("arap_flow_tpu_torch.pipeline.warp_tool", "main"),
    "texture_gen": ("arap_flow_tpu_torch.pipeline.texture_gen", "main"),
    "dmo_gen": ("arap_flow_tpu_torch.pipeline.dmo_gen", "main"),
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
