"""The window's wall over the number of solves it completed, in ms."""


def read(record):
    if not record.walls:
        return None
    return 1e3 * record.window_s / len(record.walls)
