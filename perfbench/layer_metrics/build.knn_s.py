"""Seconds of the graph build's "knn" phase in this run's rebuild()
(GraphIndex.build_seconds: each lap ends in a device synchronize)."""


def read(ctx):
    phases = ctx.build_phases
    return None if not phases or "knn" not in phases else phases["knn"]
