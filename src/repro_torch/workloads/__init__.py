from repro_torch.workloads.smallbank import make_smallbank  # noqa: F401


def make_workload(name: str, n_records: int, **kw):
    if name == "smallbank":
        return make_smallbank(n_records, **kw)
    if name in ("ycsb", "tpcc"):
        raise NotImplementedError(
            f"workload {name!r} is not ported to repro_torch yet (ROADMAP A.2); "
            "the port runs smallbank"
        )
    raise ValueError(name)
