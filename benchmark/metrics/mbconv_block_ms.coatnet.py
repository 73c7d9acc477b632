"""Device ms of one eager train step inside the port's
`tfnas.block.mbconv` spans (the stems' and every convolutional block's
apply in EvalNetwork and its backward), between their CUDA events, summed
over the step's blocks; read from one eager step after a --trace 1 run's
window. None where the program opens no such span."""

from benchmark import readers


def read(rec):
    return readers.mean_event_ms(rec, "tfnas.block.mbconv")
