"""The port's examples: the reference's ``examples/`` on the card (``--device
cpu`` runs the plain versions).  Run each as a module, e.g.
``PYTHONPATH=src python -m repro_torch.examples.quickstart``."""
