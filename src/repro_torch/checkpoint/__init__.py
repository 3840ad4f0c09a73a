from .checkpoint import (AsyncCheckpointer, latest_valid, load, save,  # noqa
                         step_path, verify)
