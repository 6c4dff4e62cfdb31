"""Fleet simulator of the port (``repro.fleet``): discrete-event multi-job
pod simulation.

Composes the per-component paper models — OCS cube scheduling
(`core.ocs`), goodput accounting (`core.goodput`), SDC detection
statistics (`core.sdc`), and per-generation TDP/perf (`core.hwspec`) —
into one executable fleet story: many concurrent training *and serving*
jobs on a simulated pod, over days of simulated time, with failures,
repairs, OCS reconfigurations, silent-data-corruption rollbacks,
autoscaled inference replicas under TTFT/TPOT SLOs, and power/carbon
integration per job. The simulator is pure Python and numpy; its step
and service times can come from steptraces that the port's trainer and
``ServeEngine`` record on the card (``fleet.perf``), and ``fleet.bridge``
holds it against the port's ``ResilientTrainer``.
"""

from repro_torch.fleet.bridge import (GRAMMAR_KINDS, grammar_ok,
                                      run_bridge, serve_calibration_check,
                                      simulate_trainer_plan)
from repro_torch.fleet.events import Event, EventEngine
from repro_torch.fleet.jobs import (JobRuntime, JobSpec,
                                    optimal_checkpoint_interval_s,
                                    search_checkpoint_interval)
from repro_torch.fleet.perf import (MeasuredStepTimeModel,
                                    ServiceTimeModel, StepTimeModel,
                                    TrainWorkload, generation_step_times,
                                    job_spec_from_roofline,
                                    job_spec_from_trace,
                                    service_model_from_trace,
                                    sim_checkpoint_interval_sweep)
from repro_torch.fleet.power import (PowerModel,
                                     generation_efficiency_table,
                                     sustainability_ratios)
from repro_torch.fleet.scenarios import (SCENARIO_SCHEMA, load_scenario,
                                         load_scenario_paths, run_scenario,
                                         validate_scenario)
from repro_torch.fleet.serve_jobs import (SERVE_SCALE_POLICIES,
                                          ArrivalProcess, ServeJobRuntime,
                                          ServeJobSpec, ServeReplica,
                                          ServeRequest, ServeSLO)
from repro_torch.fleet.sim import FleetConfig, FleetSimulator
from repro_torch.fleet.trace import TraceRecorder

__all__ = [
    "GRAMMAR_KINDS", "grammar_ok", "run_bridge",
    "serve_calibration_check", "simulate_trainer_plan",
    "Event", "EventEngine", "JobRuntime", "JobSpec",
    "optimal_checkpoint_interval_s", "search_checkpoint_interval",
    "MeasuredStepTimeModel", "ServiceTimeModel", "StepTimeModel",
    "TrainWorkload", "generation_step_times", "job_spec_from_roofline",
    "job_spec_from_trace", "service_model_from_trace",
    "sim_checkpoint_interval_sweep",
    "PowerModel", "generation_efficiency_table", "sustainability_ratios",
    "SCENARIO_SCHEMA", "load_scenario", "load_scenario_paths",
    "run_scenario", "validate_scenario",
    "SERVE_SCALE_POLICIES", "ArrivalProcess", "ServeJobRuntime",
    "ServeJobSpec", "ServeReplica", "ServeRequest", "ServeSLO",
    "FleetConfig", "FleetSimulator", "TraceRecorder",
]
