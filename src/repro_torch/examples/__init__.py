"""Twins of the reference's serving-side examples (``examples/``), run as
``python -m repro_torch.examples.<name>``: ``image_store_psnr`` and
``serve_approx_kv``. Each takes ``--device`` (the card unless ``cpu`` is
asked for)."""
