"""Architecture configs (port of ``repro.configs``; qwen2.5-3b and conformer_s)."""
