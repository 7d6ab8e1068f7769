"""Host clock around the program's ``GraphBuilder.build``, ending in a
synchronize: the storage layer's share of set-up."""


def read(r):
    return r.build_s
