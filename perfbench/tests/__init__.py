"""CPU tests of the benchmark (the card-only cases are marked ``cuda``)."""
