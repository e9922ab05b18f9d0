"""Optional progress bars: ``tqdm`` where installed, plain iteration
where not (tqdm is not a required dependency)."""


def progress(it, verbose=True, **kwargs):
    """``tqdm.tqdm(it, **kwargs)`` when tqdm is installed and ``verbose``;
    ``it`` itself otherwise."""
    if not verbose:
        return it
    try:
        import tqdm
    except ImportError:
        return it
    return tqdm.tqdm(it, **kwargs)
