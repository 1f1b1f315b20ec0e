"""One reader per metric, found by file name: KIND ("end_to_end" or
"per_layer"), UNIT and read(run) -> value or None (nothing to read)."""
