"""Scale harness of the port: declarative load scenarios + virtual-clock
driver + metrics/report layer, copies of the JAX package's ``loadgen``.

  spec       ScenarioSpec dataclass + YAML-ish dict loader
  scenarios  named scenario library (steady_poisson ... scale_10k)
  driver     VirtualClock, run_scenario, and the wall-clock trace replay
             (replay_trace); ``build_zoo_service`` is refused until the
             other families are ported (ROADMAP.md)
  metrics    deterministic EventLog (sha256 probe) + report/gate JSON
"""
from repro_torch.loadgen.driver import (  # noqa: F401
    VirtualClock, bind_apps_by_ctx, build_service, build_zoo_service,
    make_events, replay_trace, run_scenario)
from repro_torch.loadgen.metrics import (  # noqa: F401
    EventLog, build_report, gate_metrics, write_bench)
from repro_torch.loadgen.scenarios import (  # noqa: F401
    SCENARIOS, get_scenario, scenario_from_dict)
from repro_torch.loadgen.spec import (  # noqa: F401
    ScenarioSpec, load_scenario, validate_spec)
