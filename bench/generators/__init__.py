"""Graph generators, one module per kind, found by the ``generator`` key of
a configuration file: ``generate(config, seed, device) -> BenchGraph``, and
``TINY``, the configuration keys that shrink it to a test's size."""
