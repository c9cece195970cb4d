"""Experiment API of the port (DESIGN.md §8): declarative specs, component
registries, run lifecycle hooks, and bit-for-bit resumable runs.

    from repro_torch.api import ExperimentSpec, Experiment
    result = Experiment(ExperimentSpec.from_file("spec.json")).run()

CLI: `python -m repro_torch.api.cli run spec.json` / `resume CKPT_DIR` /
`sweep sweep.json --out-dir DIR`. The same spec files, sweep files,
JSON-lines results, sweep directories and checkpoints as the JAX package's
`repro.api`.
"""
from repro_torch.api.spec import (
    DataSpec, ExperimentSpec, ModelSpec, RunSpec, SchemeSpec, SpecError,
    WirelessSpec,
)
from repro_torch.api.registry import (
    CHANNEL_NOISE, DATA_SELECTION, DATASETS, FAULT_MODELS, LOCAL_SCHEMES,
    MODELS, SCHEMES, Registry, register_channel_noise,
    register_data_selection, register_dataset, register_fault_model,
    register_local_scheme, register_model, register_scheme,
)
from repro_torch.api.callbacks import (
    Callback, CheckpointCallback, StopOnEvent, load_run_state,
    restore_trainer_state, save_trainer_state,
)
from repro_torch.api.experiment import (
    Environment, Experiment, Run, RunResult, build_environment,
    resume_from_checkpoint,
)
from repro_torch.api.sweep import (
    CellTimeout, JsonlDirSink, RunSink, SweepCell, SweepInterrupted,
    SweepResult, SweepSpec, load_manifest, override_field, run_sweep,
    spec_hash, verify_cell_run, write_manifest,
)

__all__ = [
    "DataSpec", "ModelSpec", "WirelessSpec", "SchemeSpec", "RunSpec",
    "ExperimentSpec", "SpecError",
    "Registry", "MODELS", "DATASETS", "SCHEMES",
    "DATA_SELECTION", "CHANNEL_NOISE", "FAULT_MODELS", "LOCAL_SCHEMES",
    "register_model", "register_dataset", "register_scheme",
    "register_data_selection", "register_channel_noise",
    "register_fault_model", "register_local_scheme",
    "Callback", "CheckpointCallback", "StopOnEvent",
    "save_trainer_state", "restore_trainer_state", "load_run_state",
    "Environment", "build_environment", "Experiment", "Run", "RunResult",
    "resume_from_checkpoint",
    "SweepSpec", "SweepCell", "SweepResult", "RunSink", "JsonlDirSink",
    "run_sweep", "override_field", "CellTimeout", "SweepInterrupted",
    "spec_hash", "write_manifest", "load_manifest", "verify_cell_run",
]
