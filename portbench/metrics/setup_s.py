"""Process start to the first timed solve, in s: imports, CUDA start-up,
the kernels' libraries (built by nvcc on a checkout's first run), the
inputs, the program's set-up and one warm-up solve."""


def read(record):
    return record.setup_s
