"""The paper's Sec. V comparison as data: the matrix, the records of a run
and the comparison of two packages' records. It imports neither the JAX
package nor the PyTorch port: the spec classes come in as `api`, either
package's `api` module (`repro.api` or `repro_torch.api`: the same names,
the same spec dicts).

The matrix is benchmarks/common.py's six SCHEMES at
examples/feel_paper_reproduction.py's settings (ExpConfig's defaults:
synthetic-mnist, 10 clients, sigma 1, LeNet, 60 rounds, E0 4 J, T0 40 s,
evaluation every 25 rounds) x run.seed. A run's records:

  * its schedule as run (`schedule_record`): per executed round the
    selected ids, the per-client lambda, the round's delay and energy and
    the cumulative ones, beside the solver's theta / energy / delay /
    feasible. It does not depend on run.seed (the data and the channel are
    seeded from data.seed and wireless.seed), so `collect` keeps it once a
    scheme and checks it equal across seeds;
  * its outcome (`run_record`): the per-round train loss, (round, test
    loss, test accuracy) at each evaluated round, the rounds completed,
    the budgets spent, the final accuracy and the mean train loss over
    the last LAST_ROUNDS rounds.

scripts/make_sec5_jax_reference.py writes JAX's records to REFERENCE;
examples/torch_feel_paper_reproduction.py, chip_smoke.py's Sec. V phase
and the tests hold the port's to them (`compare`): every schedule bit for
bit, and each scheme's mean final accuracy and last-10 train loss within
SIGMAS standard errors of JAX's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

# benchmarks/common.py:36, the paper's comparisons:
#   proposed         joint (P1) with the generalization statement
#   no_gen           conventional bound (phi = 0 in the optimizer)
#   fixed_pruning    lambda = 0 (no pruning)
#   fixed_selection  a_n = 1 every round
#   fixed_power      p_n = 0.5 W
#   fixed_clock      f_n = f_max
SCHEMES = ("proposed", "no_gen", "fixed_pruning", "fixed_selection",
           "fixed_power", "fixed_clock")
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "torch_fixtures", "sec5_jax.json")
SEEDS = 8                # the reference's run.seed 0..7
EVAL_EVERY = 25          # examples/feel_paper_reproduction.py's cadence
LAST_ROUNDS = 10         # the train-loss statistic: mean of the last 10
SIGMAS = 3.0             # the distribution check's bound, standard errors


@dataclasses.dataclass
class ExpConfig:
    """benchmarks/common.py's ExpConfig (its defaults, :40-58)."""
    dataset: str = "synthetic-mnist"     # or synthetic-cifar10
    n_clients: int = 10
    sigma: float = 1.0
    rounds: int = 60
    eta: float = 0.1
    batch: int = 32
    n_train: int = 4000
    n_test: int = 800
    # budgets in the binding regime of the synthetic substrate
    e0: float = 4.0                      # [J]
    t0: float = 40.0                     # [s]
    seed: int = 0
    rounds_per_dispatch: int | str = "auto"


def spec_from_config(api, cfg: ExpConfig, scheme: str = "proposed", *,
                     eval_every: int = 10):
    """benchmarks/common.py's spec_from_config (:61-78) on `api`'s specs,
    at the config's budgets: the same dict, so the same spec hash in either
    package."""
    return api.ExperimentSpec(
        data=api.DataSpec(dataset=cfg.dataset, n_clients=cfg.n_clients,
                          sigma=cfg.sigma, n_train=cfg.n_train,
                          n_test=cfg.n_test, seed=cfg.seed),
        model=api.ModelSpec(
            name="lenet" if "mnist" in cfg.dataset else "resnet"),
        wireless=api.WirelessSpec(e0=cfg.e0, t0=cfg.t0, seed=cfg.seed),
        scheme=api.SchemeSpec(name=scheme, rounds=cfg.rounds, eta=cfg.eta,
                              batch=cfg.batch),
        run=api.RunSpec(seed=cfg.seed, eval_every=eval_every,
                        rounds_per_dispatch=cfg.rounds_per_dispatch))


def final_accuracy(hist) -> tuple[float, int]:
    """Last evaluated accuracy and its round; (nan, -1) without one
    (benchmarks/common.py:123-130)."""
    evals = [(m.test_accuracy, m.round) for m in (hist or [])
             if m.test_accuracy is not None]
    return evals[-1] if evals else (float("nan"), -1)


def sec5_sweep(api, seeds):
    """The matrix as `api`'s SweepSpec: the base spec x SCHEMES x
    run.seed. `seeds` is a count (0..seeds-1) or a list."""
    base = spec_from_config(api, ExpConfig(), "proposed",
                            eval_every=EVAL_EVERY)
    seeds = list(range(seeds)) if isinstance(seeds, int) else list(seeds)
    return api.SweepSpec(base=base, schemes=list(SCHEMES), seeds=seeds)


def schedule_record(result) -> dict:
    """A run's schedule as run, one record per executed round (either
    package's RunResult)."""
    s = result.schedule
    rounds = [{"round": m.round, "selected": list(m.selected),
               "lam": [float(x) for x in s.lam[m.round]],
               "delay": m.delay, "energy": m.energy,
               "cumulative_delay": m.cumulative_delay,
               "cumulative_energy": m.cumulative_energy}
              for m in result.history]
    return {"theta": float(s.theta), "energy": float(s.energy),
            "delay": float(s.delay), "feasible": bool(s.feasible),
            "rounds": rounds}


def run_record(result) -> dict:
    """A run's outcome: per-round train loss, the evaluated rounds, the
    rounds completed and the budgets spent, and the two statistics."""
    hist = result.history
    evals = [[m.round, m.test_loss, m.test_accuracy] for m in hist
             if m.test_accuracy is not None]
    losses = [m.train_loss for m in hist]
    acc, acc_round = final_accuracy(hist)
    return {"train_loss": losses, "evals": evals,
            "rounds_completed": len(hist),
            "cumulative_energy": hist[-1].cumulative_energy,
            "cumulative_delay": hist[-1].cumulative_delay,
            "final_accuracy": acc, "final_accuracy_round": acc_round,
            "last10_train_loss": float(np.mean(losses[-LAST_ROUNDS:]))}


def collect(cells, results) -> dict:
    """{scheme: {"schedule": record, "runs": {seed: record}}} from a
    sweep's cells and results. The schedule must not depend on the seed."""
    out: dict = {}
    for cell, result in zip(cells, results):
        if result is None:
            raise RuntimeError(f"sweep cell {cell.name} failed")
        name, seed = cell.spec.scheme.name, cell.spec.run.seed
        rec = schedule_record(result)
        entry = out.setdefault(name, {"schedule": rec, "runs": {}})
        if rec != entry["schedule"]:
            raise RuntimeError(f"{name}: the schedule differs at seed {seed}")
        entry["runs"][str(seed)] = run_record(result)
    return out


def load_reference() -> dict:
    with open(REFERENCE) as f:
        return json.load(f)


def mean_std(xs) -> tuple[float, float]:
    """Mean and sample standard deviation (ddof 1; 0 for one value)."""
    a = np.asarray(xs, np.float64)
    return float(a.mean()), float(a.std(ddof=1)) if a.size > 1 else 0.0


def summarize(entry: dict) -> dict:
    """One scheme's outcome over the entry's seeds."""
    rs = [entry["runs"][k] for k in sorted(entry["runs"], key=int)]
    sched = entry["schedule"]["rounds"]
    acc, acc_sd = mean_std([r["final_accuracy"] for r in rs])
    loss, loss_sd = mean_std([r["last10_train_loss"] for r in rs])
    lam = [x for rec in sched for i, x in enumerate(rec["lam"])
           if i in rec["selected"]]
    return {"seeds": len(rs), "final_accuracy": acc,
            "final_accuracy_std": acc_sd, "last10_train_loss": loss,
            "last10_train_loss_std": loss_sd,
            "rounds_completed": rs[0]["rounds_completed"],
            "energy": rs[0]["cumulative_energy"],
            "delay": rs[0]["cumulative_delay"],
            "clients_per_round": float(np.mean(
                [len(rec["selected"]) for rec in sched])),
            "mean_lambda": float(np.mean(lam)) if lam else 0.0}


def schedule_problems(port: dict, reference: dict) -> list[str]:
    """Every scheme's schedule as run and, for every seed both hold, the
    rounds completed and the cumulative energy and delay, bit for bit."""
    problems = []
    for name in port:
        ref = reference["schemes"].get(name)
        if ref is None:
            problems.append(f"{name}: not in the reference")
            continue
        if port[name]["schedule"] != ref["schedule"]:
            problems.append(f"{name}: the schedule differs from JAX's")
        for seed, rec in port[name]["runs"].items():
            jrec = ref["runs"].get(seed)
            if jrec is None:
                continue
            for key in ("rounds_completed", "cumulative_energy",
                        "cumulative_delay"):
                if rec[key] != jrec[key]:
                    problems.append(f"{name} seed {seed}: {key} {rec[key]!r}"
                                    f" != JAX's {jrec[key]!r}")
    return problems


def distribution_check(port: dict, jax: dict, n_port: int,
                       n_jax: int) -> dict:
    """For each statistic, |mean_port - mean_jax| against SIGMAS standard
    errors of the difference; "ok" is None (not checked) when either side
    has fewer than two seeds, where no standard deviation is estimated."""
    out = {}
    for stat in ("final_accuracy", "last10_train_loss"):
        diff = abs(port[stat] - jax[stat])
        se = math.sqrt(port[stat + "_std"] ** 2 / n_port
                       + jax[stat + "_std"] ** 2 / n_jax)
        out[stat] = {"diff": diff, "bound": SIGMAS * se,
                     "ok": bool(diff <= SIGMAS * se)
                     if min(n_port, n_jax) >= 2 else None}
    return out


def verdict(summaries: dict) -> dict:
    """proposed against the best baseline, by mean final accuracy."""
    best = max((k for k in summaries if k != "proposed"),
               key=lambda k: summaries[k]["final_accuracy"])
    p = summaries["proposed"]["final_accuracy"]
    b = summaries[best]["final_accuracy"]
    return {"proposed": p, "best_baseline": best, "best_baseline_accuracy": b,
            "result": "WIN" if p >= b else "LOSS"}


def table(port: dict, jax: dict, checks: dict | None = None) -> list[str]:
    """One line a scheme: the port's numbers, JAX's beside them."""
    lines = [f"{'scheme':16s} {'final acc (port)':>17s} {'(JAX)':>15s} "
             f"{'last-10 loss (port)':>20s} {'(JAX)':>15s} {'rounds':>6s} "
             f"{'E (J)':>9s} {'D (s)':>9s} {'clients':>7s} {'lambda':>7s}"
             + ("  check" if checks else "")]
    for name in port:
        p, j = port[name], jax[name]
        mark = ""
        if checks:
            oks = [c["ok"] for c in checks[name].values()]
            mark = "  " + ("-" if None in oks else "ok" if all(oks)
                           else "OUT")
        lines.append(
            f"{name:16s} {p['final_accuracy']:.3f} +- "
            f"{p['final_accuracy_std']:.3f}  {j['final_accuracy']:.3f} +- "
            f"{j['final_accuracy_std']:.3f}    {p['last10_train_loss']:.4f} "
            f"+- {p['last10_train_loss_std']:.4f} {j['last10_train_loss']:.4f}"
            f" +- {j['last10_train_loss_std']:.4f} "
            f"{p['rounds_completed']:6d} {p['energy']:9.4f} "
            f"{p['delay']:9.4f} {p['clients_per_round']:7.2f} "
            f"{p['mean_lambda']:7.4f}{mark}")
    return lines


def compare(port: dict, reference: dict) -> dict:
    """Summaries of both packages, the two checks and the verdicts."""
    jax_all = {name: summarize(reference["schemes"][name]) for name in port}
    port_sum = {name: summarize(port[name]) for name in port}
    checks = {name: distribution_check(port_sum[name], jax_all[name],
                                       port_sum[name]["seeds"],
                                       jax_all[name]["seeds"])
              for name in port}
    return {"port": port_sum, "jax": jax_all, "checks": checks,
            "schedule_problems": schedule_problems(port, reference),
            "verdict": verdict(port_sum) if "proposed" in port_sum and
            len(port_sum) > 1 else None,
            "jax_verdict": verdict(jax_all) if "proposed" in jax_all and
            len(jax_all) > 1 else None}
