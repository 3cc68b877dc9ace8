"""From the process's start to the first timed tick: imports, the build
or load of the program's libraries, the engine, the audio, the captures
and the warm-up ticks that fill the ring (host clock)."""


def read(run):
    return run.setup_s
