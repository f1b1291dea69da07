"""Models of the LM side branch (port of ``repro.models``): blocks and
the CompositeLM."""
