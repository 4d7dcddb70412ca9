"""Datasets: B3DB loaders (``b3db``, needs pandas) and ZINC streams plus the
seeded synthetic feedstock (``zinc``).

The B3DB names resolve lazily, so importing this package (as the screening
pipeline does through ``bbbp.data.zinc``) loads no pandas.
"""

_B3DB_NAMES = (
    "load_b3db_regression",
    "load_b3db_classification",
    "B3DB_REGRESSION_TSV",
    "B3DB_CLASSIFICATION_TSV",
)

__all__ = list(_B3DB_NAMES)


def __getattr__(name):
    if name in _B3DB_NAMES:
        from bbbp.data import b3db

        return getattr(b3db, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
