"""Vertex programs a traffic mix can name (its ``program`` key), one module
each: the program's object for the system under test, the plain reference
that recomputes its answers, and the comparison with its number."""
