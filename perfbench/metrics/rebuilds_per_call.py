"""Rebuilds of a cached artifact (a program, a schedule, K1's tables, a
K2 program, a kernel library) a call: the program's
``repro_torch.build.*`` spans in the traced calls over their number."""
from perfbench.spans import device_calls


def read(rec):
    calls = device_calls(rec)
    if calls is None:
        return None
    builds = sum(name.startswith("build.") for c in calls for name, _, _ in c)
    return builds / len(calls)
