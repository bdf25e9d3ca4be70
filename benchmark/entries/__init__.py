"""How each configuration's system is built and called: one module per entry,
named by a configuration's `entry` (see `core.py`)."""
