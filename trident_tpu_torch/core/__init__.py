"""Host configuration, logging and ids."""
