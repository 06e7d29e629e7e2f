"""End-to-end metrics, one module a metric name: ``read(run)`` returns the
value, or ``None`` where the cell has nothing for it to read."""
