import os

# Some tests seed from hash() of strings, which Python randomises per process:
# pin the seed before pytest-xdist starts its workers, which inherit it.
os.environ.setdefault("PYTHONHASHSEED", "0")
