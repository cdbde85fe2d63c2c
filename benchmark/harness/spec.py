"""What a cell is, read by name from ``BENCHMARK.json`` and the benchmark's
data files: the workload entry, its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
the limits of its output check (``limits/<workload>.json``) and the
metrics it reports. Adding a cell adds entries and files; nothing here
names one."""
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    def __init__(self, workload: str, root: Path = ROOT):
        self.bench = load_json(root / 'BENCHMARK.json')
        entries = {w['name']: w for w in self.bench['workloads']}
        if workload not in entries:
            raise SystemExit(f"unknown workload {workload!r}; one of "
                             f"{sorted(entries)}")
        self.entry = entries[workload]
        self.name = workload
        self.chips = int(self.entry['chips'])
        self.config = load_json(BENCH_DIR / 'configs'
                                / f"{self.entry['config']}.json")
        self.traffic = load_json(BENCH_DIR / 'traffic'
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH_DIR / 'limits' / f'{workload}.json')

    @staticmethod
    def all_workloads(root: Path = ROOT):
        return load_json(root / 'BENCHMARK.json')['workloads']

    def _reports(self, metric) -> bool:
        return 'workloads' not in metric or self.name in metric['workloads']

    @property
    def end_to_end(self):
        return [m for m in self.bench['end_to_end'] if self._reports(m)]

    @property
    def per_layer(self):
        reported = {m['name'] for m in self.end_to_end}
        return [m for m in self.bench['per_layer']
                if (self.name in m['workloads'] if 'workloads' in m
                    else m['moves'] in reported)]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return load_module(BENCH_DIR / 'metrics' / f'{name}.py',
                       'metric_' + name.replace('.', '_')).read


def kind_module(kind: str):
    return load_module(BENCH_DIR / 'kinds' / f'{kind}.py', 'kind_' + kind)


def flops_module(config: str):
    return load_module(BENCH_DIR / 'flops' / f'{config}.py',
                       'flops_' + config)


def reference_module(family: str):
    return importlib.import_module(f'reference.{family}')
