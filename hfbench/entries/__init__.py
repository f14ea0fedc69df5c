"""Entry points the window drives, one module per entry (see ``hfbench``)."""
