"""The result's ``device`` measures the cards a run used.  On the CPU, stub
loops report their cards through ``Driver.devices()`` into
``harness.run_cell``: four cards of one kind give ``count`` 4 and the
fullest card's peak; fewer cards than the cell's ``chips``, or cards of
more than one kind, make ``run.py`` print no result; the one-card loops
refuse more cards; the cells at test size report one.  On a machine with
four cards, four ranks (rank 0 in the harness process, an NCCL
all-reduce a unit) report four, four ranks kept on card 0 print no
result, and the harness's own reading touches no card the run left
alone."""

import datetime
import json
import multiprocessing
import sys
import time
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from benchmark import harness
from benchmark.loops import cli_sweep, staged_solve
from conftest import ROOT, small_spec

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
H100 = "NVIDIA H100 80GB HBM3"
PEAKS = [39_966_208, 42_223_104, 41_750_528, 40_960_000]


def card(index, peak, name=H100, uuid=None):
    return {"index": index, "name": name,
            "uuid": uuid or f"GPU-{index}", "memory_peak_bytes": peak}


def stub_spec(chips, traffic=None):
    """A cell of ``chips`` cards on the loop ``stub``, made here: no metric,
    and the only limit the one the harness computes itself."""
    return SimpleNamespace(
        name="stub", cell={"chips": chips}, config={},
        traffic=dict(traffic or {}, loop="stub"),
        limits={"unconverged_share": 0.0}, end_to_end=[], per_layer=[])


def run_stub(monkeypatch, capsys, driver, spec, device="cpu"):
    """``run_cell`` and ``run.py``'s ``emit`` over the loop ``driver``:
    ``(out, exit code, stdout, stderr)``."""
    monkeypatch.setitem(sys.modules, "benchmark.loops.stub",
                        SimpleNamespace(Driver=driver))
    monkeypatch.setattr("benchmark.yardstick.nvidia_smi", lambda: "card")
    run = harness.load_module(ROOT / "benchmark" / "run.py", "benchmark_run")
    out = harness.run_cell(ROOT, spec.name, 20260104, 0.0, False, device,
                           time.perf_counter(), spec=spec)
    capsys.readouterr()
    rc = run.emit(out)
    printed = capsys.readouterr()
    return out, rc, printed.out, printed.err


class Empty:
    """A loop of empty units that reports no cards of its own."""
    work_unit = "step"

    def __init__(self, config, traffic, seed, device, chips=1):
        pass

    def warm_up(self):
        pass

    def unit(self, k):
        return {"work": 1, "failed": 0, "attempted": 1}

    def counters(self):
        return {}

    def release(self):
        pass

    def check(self, records):
        return {}


def reporting(cards):
    """An empty loop whose ``devices()`` gives ``cards``; it keeps the
    ``chips`` it was built with in ``made``."""
    class Driver(Empty):
        made = []

        def __init__(self, config, traffic, seed, device, chips=1):
            self.made.append(chips)

        def devices(self):
            return [dict(c) for c in cards]
    return Driver


def test_four_cards_of_one_kind(monkeypatch, capsys):
    driver = reporting([card(i, p) for i, p in enumerate(PEAKS)])
    out, rc, stdout, _ = run_stub(monkeypatch, capsys, driver, stub_spec(4))
    assert driver.made == [4]
    dev = out["result"]["device"]
    assert (dev["platform"], dev["kind"], dev["count"]) == ("cpu", H100, 4)
    assert dev["memory_peak_bytes"] == max(PEAKS)
    assert dev["per_device"] == [{"index": i, "name": H100,
                                  "memory_peak_bytes": p}
                                 for i, p in enumerate(PEAKS)]
    assert rc == 0
    assert json.loads(stdout.strip().splitlines()[-1])["device"] == dev


SHORT = {
    "one card": [card(0, PEAKS[0])],
    "four ranks on card 0": [card(0, p, uuid="GPU-0") for p in PEAKS],
    "mixed kinds": [card(i, p, name=H100 if i % 2 else "NVIDIA A100 80GB")
                    for i, p in enumerate(PEAKS)],
}


@pytest.mark.parametrize("case", SHORT)
def test_cards_that_do_not_stand_for_the_cell_give_no_result(
        case, monkeypatch, capsys):
    out, rc, stdout, stderr = run_stub(monkeypatch, capsys,
                                       reporting(SHORT[case]), stub_spec(4))
    assert rc != 0
    assert stdout == ""
    errors = [ln for ln in stderr.splitlines() if ln.startswith("error:")]
    assert len(errors) == 1 and "card 0" in errors[0], stderr
    assert "check " not in stderr
    if case == "four ranks on card 0":
        dev = out["result"]["device"]
        assert dev["count"] == 1 and dev["memory_peak_bytes"] == sum(PEAKS)


@pytest.mark.parametrize("loop", [cli_sweep, staged_solve],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_one_card_loops_refuse_more_cards(loop):
    cell = next(c for c in CELLS if small_spec(c).traffic["loop"]
                == loop.__name__.split(".")[-1])
    spec = small_spec(cell)
    spec.cell["chips"] = 4
    with pytest.raises(ValueError, match="one card"):
        harness.driver_of(spec, 1, "cpu")
    with pytest.raises(ValueError, match="one card"):
        loop.Driver(spec.config, spec.traffic, 1, "cpu", chips=4)


@pytest.mark.parametrize("workload", CELLS)
def test_cells_at_test_size_report_one_card(workload, monkeypatch, capsys):
    spec = small_spec(workload)
    loop = (staged_solve if spec.traffic["loop"] == "staged_solve"
            else cli_sweep)
    monkeypatch.setattr(loop.Driver, "warm_up", lambda self: None)
    monkeypatch.setattr("benchmark.yardstick.nvidia_smi", lambda: "card")
    run = harness.load_module(ROOT / "benchmark" / "run.py", "benchmark_run")
    out = harness.run_cell(ROOT, workload, 20260105, 0.0, False, "cpu",
                           time.perf_counter(), spec=spec)
    capsys.readouterr()
    assert run.emit(out) == 0
    dev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "device"]
    assert dev == {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0,
                   "per_device": [{"index": 0, "name": "cpu",
                                   "memory_peak_bytes": 0}]}


# ---- on the card: ranks in processes of their own --------------------

def join(rank, world, store, cards):
    """Join the default group as ``rank`` on card ``cards[rank]``: NCCL
    where every rank has a card of its own, else gloo."""
    device = torch.device("cuda", cards[rank])
    torch.cuda.set_device(device)
    backend = "nccl" if len(set(cards)) == world else "gloo"
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    return device


def work(device):
    """Allocate and launch on ``device``, then all-reduce one number."""
    x = torch.randn(1024, 1024, device=device)
    total = (x @ x).sum().reshape(1)
    dist.all_reduce(total if dist.get_backend() == "nccl" else total.cpu())
    torch.cuda.synchronize(device)


def rank_main(rank, world, store, cards, commands, replies):
    device = join(rank, world, store, cards)
    for command in iter(commands.get, "stop"):
        if command == "unit":
            work(device)
        else:
            replies.put(harness.local_devices(device))
    dist.destroy_process_group()


class RankDriver(Empty):
    """Rank 0 in the harness process, ranks 1… spawned, each on its card
    of ``traffic["cards"]``; ``devices()`` gathers every rank's
    ``local_devices``."""

    def __init__(self, config, traffic, seed, device, chips=1):
        cards, store = traffic["cards"], traffic["store"]
        ctx = multiprocessing.get_context("spawn")
        self.commands = [ctx.Queue() for _ in cards[1:]]
        self.replies = ctx.Queue()
        self.ranks = [ctx.Process(target=rank_main,
                                  args=(r, len(cards), store, cards, q,
                                        self.replies))
                      for r, q in enumerate(self.commands, 1)]
        for p in self.ranks:
            p.start()
        self.device = join(0, len(cards), store, cards)

    def tell(self, command):
        for q in self.commands:
            q.put(command)

    def warm_up(self):
        self.unit(-1)

    def unit(self, k):
        self.tell("unit")
        work(self.device)
        return super().unit(k)

    def devices(self):
        self.tell("devices")
        out = harness.local_devices(self.device)
        for _ in self.ranks:
            out += self.replies.get(timeout=120)
        return out

    def release(self):
        self.tell("stop")
        dist.destroy_process_group()    # with every rank: NCCL's is collective
        for p in self.ranks:
            p.join(timeout=120)
        alive = [p for p in self.ranks if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive


class OwnCardDriver(Empty):
    """Work on card 0 in the harness process and no ``devices()``: the
    harness reads its own process."""

    def unit(self, k):
        x = torch.randn(1024, 1024, device="cuda:0")
        (x @ x).sum().item()
        return super().unit(k)


def cards_or_skip(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")


@pytest.mark.cuda
def test_the_harness_reads_only_cards_the_run_touched(monkeypatch, capsys):
    cards_or_skip(2)
    out, rc, stdout, _ = run_stub(monkeypatch, capsys, OwnCardDriver,
                                  stub_spec(1), device="cuda")
    dev = out["result"]["device"]
    assert rc == 0 and (dev["count"], dev["kind"]) == (
        1, torch.cuda.get_device_name(0))
    assert [c["index"] for c in dev["per_device"]] == [0]
    assert dev["memory_peak_bytes"] == torch.cuda.max_memory_allocated(0)
    assert not any(torch._C._cuda_hasPrimaryContext(i)
                   for i in range(1, torch.cuda.device_count()))


@pytest.mark.cuda
@pytest.mark.parametrize("cards,count", [((0, 1, 2, 3), 4),
                                         ((0, 0, 0, 0), 1)],
                         ids=["a card a rank", "every rank on card 0"])
def test_four_ranks_report_their_cards(cards, count, tmp_path, monkeypatch,
                                       capsys):
    cards_or_skip(4)
    spec = stub_spec(4, {"cards": list(cards),
                         "store": (tmp_path / "store").as_uri()})
    out, rc, stdout, stderr = run_stub(monkeypatch, capsys, RankDriver, spec,
                                       device="cuda")
    dev = out["result"]["device"]
    assert dev["count"] == count
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] == max(
        c["memory_peak_bytes"] for c in dev["per_device"]) > 0
    if count == 4:
        assert rc == 0, stderr
        assert json.loads(stdout.strip().splitlines()[-1])["device"] == dev
    else:
        assert rc != 0 and stdout == "" and "error:" in stderr
