"""The port's twins of the repository's ``examples/``: the same plans and
calls, on the card unless ``--device cpu``."""
