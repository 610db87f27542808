"""The paper's FL models and the train step."""
from repro_torch.models.small import (  # noqa: F401
    CharLSTM,
    LogisticRegression,
    SmallCNN,
)
