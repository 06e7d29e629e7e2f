"""The operations a traffic mix drives, one module an ``op``.  Each exposes
a class ``Op(run)``: set-up in its constructor, ``len()`` the items,
``call(i)`` the timed API call on item ``i``, ``sizes(i, out)`` the
(field bytes, stored bytes) of a call, ``kept(out)`` what the check keeps
of a call, ``release()`` to drop the program's state after the window,
and ``check(kept)`` the compared numbers of the kept calls, one dict a
call; the module's ``LIMITS`` adds limits to the guarantee's."""
