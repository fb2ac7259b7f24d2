"""ray_tpu_torch.tune: hyperparameter search over trial actors + placement groups.

Reference surface: ray.tune (SURVEY.md §2.4 Tune row) — Tuner/TuneConfig,
grid/random search spaces, ASHA + PBT schedulers, report/get_checkpoint
from inside a trial fn (shared with ray_tpu_torch.train's session, as in the
reference where Train v2 runs on Tune).
"""
from ray_tpu_torch.train.session import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.searcher import BasicVariantGenerator, BOHBSearcher, Searcher, TPESearcher
from ray_tpu_torch.tune.tuner import (
    ResultGrid,
    TrialResult,
    TuneConfig,
    TuneController,
    Tuner,
)

__all__ = [
    "ASHAScheduler",
    "BOHBSearcher",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TPESearcher",
    "TrialResult",
    "TrialScheduler",
    "TuneConfig",
    "TuneController",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "sample_from",
    "uniform",
]
