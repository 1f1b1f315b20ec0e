"""Host image helpers."""
