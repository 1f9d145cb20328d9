"""The paper's TM model zoo (Table IV), copied from
``repro.configs.imbue_tm`` for the port."""

from __future__ import annotations

from typing import Dict

from repro_torch.core.tm import TMConfig

# features per model: ta_cells = clauses_total * 2 * features
TM_ZOO: Dict[str, TMConfig] = {
    "imbue-tm-xor": TMConfig(n_classes=2, clauses_per_class=12,
                             n_features=12, n_states=100, threshold=15,
                             specificity=3.9),
    "imbue-tm-mnist": TMConfig(n_classes=10, clauses_per_class=200,
                               n_features=784, n_states=127, threshold=50,
                               specificity=10.0),
    "imbue-tm-kws6": TMConfig(n_classes=6, clauses_per_class=300,
                              n_features=377, n_states=127, threshold=50,
                              specificity=10.0),
    "imbue-tm-kmnist": TMConfig(n_classes=10, clauses_per_class=500,
                                n_features=784, n_states=127,
                                threshold=50, specificity=10.0),
    "imbue-tm-fmnist": TMConfig(n_classes=10, clauses_per_class=500,
                                n_features=784, n_states=127,
                                threshold=50, specificity=10.0),
}


def tm_config(name: str) -> TMConfig:
    return TM_ZOO[name]
