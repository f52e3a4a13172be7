"""The port's benchmark: ``python -m benchmark.run`` runs one cell of
``BENCHMARK.json`` once on the card(s) and prints its result line."""
