"""EXTENT core of the port: the paper's contribution as a torch subsystem.

Layering mirrors the paper's cross-layer design (and ``repro.core``):

  device      -> mtj.py          MTJ cell physics: Ic, TMR(T), s-LLGS macrospin
  circuit     -> wer.py          write-error-rate equations (Eq. 1-3, 14-15)
              -> write_driver.py 4-level approximate write driver (Table 1)
              -> ecc.py          the SEC-DED alternative, for comparison
  tensor      -> approx_store.py approximate tensor write/read primitive
  architecture-> extent_table.py quality table + controller
              -> cache_sim.py    LLC write-transition simulator (Fig 13/14)
  application -> priority.py     priority-tagging API (Rely/ACCEPT analogue)
  evaluation  -> energy_model.py per-step energy accounting + Monte-Carlo PV
"""
from repro_torch.core.priority import (  # noqa: F401
    Priority, bitplane_priorities, checkpoint_policy, kv_cache_policy,
    priority_mask, tag_pytree,
)
from repro_torch.core.write_driver import (  # noqa: F401
    TABLE1, DriverConfig, LevelSpec, default_driver, level_table,
    word_energy_pj, word_latency_ns,
)
from repro_torch.core.approx_store import (  # noqa: F401
    ApproxStore, WriteStats, approx_write, approx_write_with_stats,
    inject_soft_errors, oracle_write,
)
from repro_torch.core.wer import (  # noqa: F401
    expected_pulse_fraction, switching_probability, switching_time,
    wer_bit, wer_from_level, wer_thermal,
)
from repro_torch.core.extent_table import (  # noqa: F401
    ExtentTable, QualityController,
)
from repro_torch.core.energy_model import (  # noqa: F401
    StepEnergyMeter, monte_carlo_variation, voltage_sweep,
)
