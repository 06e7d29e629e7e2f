"""Data generators, one module a generator, named by a configuration's
``data.generator``.  Each exposes ``make(spec, seed, device)`` returning a
``(fields, n)`` uint8 tensor on ``device``: one row a field.  A generator
whose spec has keys of its own also exposes ``small(spec, elements,
fields)``: the spec at the tests' small sizes, about ``elements``
elements a field."""
