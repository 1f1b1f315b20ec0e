"""Host-side transform math (numpy)."""
