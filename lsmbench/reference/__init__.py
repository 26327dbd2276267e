"""The benchmark's plain reference (imports torch only)."""
