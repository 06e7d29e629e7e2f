"""Data generators, one module a generator, named by a configuration's
``data.generator``.  Each exposes ``make(spec, seed, device)`` returning a
``(fields, n)`` uint8 tensor on ``device``: one row a field."""
