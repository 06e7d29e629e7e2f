"""Per-layer metrics, one module a family (the part of the metric's name
before the first dot).  ``read(run, variant)`` returns the value for the
variant (``write`` or ``read``), or ``None`` where it finds nothing to
read.  Optional: ``prepare(run)`` runs in the traced run's set-up, and
``snapshot(run)`` at the window's start and end (``run.snapshots``)."""
