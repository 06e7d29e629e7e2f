"""The model zoo: ten architectures' layers in PyTorch, the reference's
``repro.models`` module for module (``common``, ``mlp``, ``attention``,
``ssm``, ``transformer``, ``model``) plus ``convert``, which carries the
reference's weights across.  Plain PyTorch: no kernel of the port runs
here."""
