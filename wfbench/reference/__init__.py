"""The plain float64 reference that decides whether a run is correct.

NumPy only: it imports nothing of the program under test, and takes
nothing the program built (no window table, rebin matrix, pixel index or
ring).  Everything is worked out again from a configuration's settings and
the audio the traffic generator fed.
"""
