from repro_torch.workloads.smallbank import make_smallbank  # noqa: F401
from repro_torch.workloads.tpcc import make_tpcc_neworder  # noqa: F401
from repro_torch.workloads.ycsb import make_ycsb  # noqa: F401


def make_workload(name: str, n_records: int, **kw):
    if name == "smallbank":
        return make_smallbank(n_records, **kw)
    if name == "ycsb":
        return make_ycsb(n_records, **kw)
    if name == "tpcc":
        return make_tpcc_neworder(n_records, **kw)
    raise ValueError(name)
