"""One comparator for the JSON trees the port's studies write, shared by the
test modules (imports neither JAX nor the port)."""


def close(got, want, tol, path="", strings=True):
    """got equals want through dicts and lists: the same keys and lengths,
    numbers within tol, booleans and None equal, strings equal unless
    `strings` is false (paths and device names differ between two runs)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            close(got[k], want[k], tol, f"{path}/{k}", strings)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, tol, f"{path}[{i}]", strings)
    elif isinstance(want, str):
        assert not strings or got == want, (path, got, want)
    elif isinstance(want, bool) or want is None:
        assert got == want, (path, got, want)
    else:
        assert abs(float(got) - float(want)) <= tol, (path, got, want)
