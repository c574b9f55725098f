"""cold.table_copy_s: the port's span setup_phases["table_copy"] of each
cold prove's new Prover (the point tables' host-to-card copies, ended by
a synchronisation), averaged over the window."""

from benchmark.spans import window


def read(run):
    return window(run, "setup_phases", "table_copy")
