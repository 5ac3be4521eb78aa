"""A frozen copy of the port's plain-torch WORLD modules (DIO, StoneMask,
CheapTrick, D4C, the harmonic synthesizer) as they stood when this benchmark
was added, with their imports pointed here: the reference's WORLD analysis
and synthesis, which imports nothing of the program."""
