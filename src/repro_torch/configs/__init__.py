"""Architecture configs (port of ``repro.configs``; qwen2.5-3b, recurrentgemma-2b and
conformer_s)."""
