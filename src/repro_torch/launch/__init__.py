"""Entry-point scripts of the port (``serve``: the continuous-batching
engine demo)."""
