"""The iterations partial_hevp printed for each traced solve on the
device LOBPCG engine (engine 'auto' or 'device'), their mean."""


def read(record):
    its = [i for i in record.iterations if i is not None]
    if record.trace is None or record.cell['engine'] == 'core' or not its:
        return None
    return sum(its) / len(its)
