"""A third module, reached only through a re-export."""


def rank(x):
    return x.argsort()[0].tolist()  # expect: JIT001
