"""The operations a traffic mix drives, one module an ``op``.  Each exposes
a class ``Op(run)``: set-up in its constructor, ``direction`` (``write``
or ``read``), ``len()`` the items, ``call(i)`` the timed API call on item
``i``, ``sizes(i, out)`` the (field bytes, stored bytes) of a call,
``kept(out)`` what the check keeps of a call, ``release()`` to drop the
program's state after the window, and ``check(kept)`` the compared
numbers of the kept calls, one dict a call; optionally
``item_fields(i)``, the flat byte slices item ``i`` compresses (by
default its row of the fields).  The module's ``ENTRY`` names the
``repro_torch.core.lzss`` function the timed call goes through, and its
``LIMITS`` adds limits to the guarantee's.

For the tests: ``Op.traced_counts(call)`` gives the (bytes copied, host
syncs) the program's tracer should count for one call, and a module's
``small(traffic)`` the mix at the tests' small sizes."""
