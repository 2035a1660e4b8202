"""The examples of ``examples/``, ported: ``quickstart``, ``serve_batched``,
``fault_tolerant_training`` and ``train_lm_e2e``. Each runs as
``python -m repro_torch.examples.<name>`` on the card unless ``--device
cpu``, and its ``main`` returns the numbers it prints."""
