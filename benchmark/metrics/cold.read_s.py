"""cold.read_s: the port's spans last_phases["io.read_zkey"] +
["io.read_wtns"] of each cold prove (cli.run_prove's file reads, host
seconds; a mapped zkey's point pages are read later, in the set-up's
table_stage), averaged over the window."""

from benchmark.spans import window


def read(run):
    return window(run, "phases", "io.read_zkey", "io.read_wtns")
