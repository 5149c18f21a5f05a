"""Traffic generators: numpy code that makes each cell's inputs from the
seed and the parameters of its traffic file."""
