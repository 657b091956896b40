"""Plain references, one a configuration kind, found by the configuration's
"reference" key. Plain PyTorch over the raw data the benchmark made: they
import nothing of the program and read nothing the program made.

Each module has a class `Reference(raw, queries, dev, precision)` whose
`distances(qidx)` returns, for a block of at most `Reference.block` pool
queries, the [n, B] distances of every row to each (smaller is nearer) and
the scale against which an error in a reported distance is measured (None:
the distance's own magnitude). `precision` is "float64" for the reference
and the configuration's "control" for the control: the same arithmetic in
the precision below the one the configuration states.
"""
