"""See the package docstring of aphantasia_torch."""
