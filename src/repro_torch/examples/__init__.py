"""Twins of the reference's examples (``examples/``), run as
``python -m repro_torch.examples.<name>``: ``image_store_psnr``,
``serve_approx_kv``, ``quickstart`` and ``train_lm_extent``. Each takes
``--device`` (the card unless ``cpu`` is asked for)."""
