"""The configurations' scenes on the program, one module per scene kind,
each with its class `SCENE`."""
