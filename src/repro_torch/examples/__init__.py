"""The reference's ``examples/`` as thin drivers over the port's APIs, run
as ``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu``)."""
