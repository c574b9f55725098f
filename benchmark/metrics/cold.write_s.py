"""cold.write_s: the port's span last_phases["io.write"] of each cold
prove (cli.run_prove's proof.json and public.json writes, host seconds),
averaged over the window."""

from benchmark.spans import window


def read(run):
    return window(run, "phases", "io.write")
