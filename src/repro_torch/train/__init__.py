"""repro_torch.train — the training state the port stores in NVM.

  * ``optimizer``   — elementwise AdamW (float32 moments) with the
                      reference's warmup-cosine schedule and global-norm
                      clipping; ``OptState`` is a NamedTuple;
  * ``compression`` — int8 error-feedback gradient compression, its int8
                      wire buffer optionally written through the EXTENT
                      substrate (``memory.write``);
  * ``checkpoint``  — ``Checkpointer``: atomic, asynchronous, pruned
                      checkpoints whose approximate leaves (optimizer
                      moments) are written through the EXTENT substrate,
                      with delta elimination and a decay-and-scrub
                      integrity pass on restore.

Each mirrors its ``repro.train`` counterpart; the on-disk checkpoint
format is the reference's, so each package restores the other's.
"""
