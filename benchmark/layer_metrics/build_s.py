"""build_s (s, host build, moves setup_s): the port's
``cached_build_timed`` ``build_s`` for the configuration's builder: the
cold build's seconds on a miss, the load's on a hit."""


def read(cell):
    return cell.build_info["build_s"]
