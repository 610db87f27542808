"""The paper's FL models, the decoder ``Model`` (dense, MoE, SSM and
hybrid families), the MoE FFN, the Mamba2 block, the mLSTM block and the
train step."""
from repro_torch.models import xlstm  # noqa: F401
from repro_torch.models.model import IGNORE, Model  # noqa: F401
from repro_torch.models.small import (  # noqa: F401
    CharLSTM,
    LogisticRegression,
    SmallCNN,
)
from repro_torch.models.training import (  # noqa: F401
    make_eval_step,
    make_grad_fn,
    make_train_step,
)
