"""Dataset preparation (the port's copy of `reconvat_tpu/train/prepare.py`,
reference `prepare_dataset` and `prepare_VAT_dataset`,
`model/helper_functions.py:23-117`): the same split tables; dataset roots
default to the reference's (`./MAPS`, `../../public_data/MAESTRO/`,
`./MusicNet`, `./Guqin`) and are overridden by `data_roots` or the
`RECONVAT_<NAME>_ROOT` environment variables.
"""
from __future__ import annotations

import os

from ..data.datasets import MAESTRO, MAPS, Guqin, MusicNet

DEFAULT_ROOTS = {
    "MAPS": "./MAPS",
    "MAESTRO": "../../public_data/MAESTRO/",
    "MusicNet": "./MusicNet",
    "Guqin": "./Guqin",
}


def _roots(data_roots=None):
    roots = dict(DEFAULT_ROOTS)
    roots.update(data_roots or {})
    for key in roots:
        env = os.environ.get(f"RECONVAT_{key.upper()}_ROOT")
        if env:
            roots[key] = env
    return roots


def prepare_VAT_dataset(sequence_length, validation_length, refresh,
                        small=False, supersmall=False, dataset="MAPS",
                        data_roots=None):
    """Returns (labeled, unlabeled, validation, full_validation)."""
    roots = _roots(data_roots)
    train_groups = ["train"]

    if dataset == "MAPS":
        if small:
            l_set = MAPS(roots["MAPS"], groups=["AkPnBcht"],
                         sequence_length=sequence_length, overlap=False,
                         refresh=refresh, supersmall=supersmall)
        else:
            l_set = MAPS(roots["MAPS"],
                         groups=["AkPnBcht", "AkPnBsdf", "AkPnCGdD",
                                 "AkPnStgb", "SptkBGAm", "SptkBGCl",
                                 "StbgTGd2"],
                         sequence_length=sequence_length, overlap=False,
                         refresh=refresh)
        ul_set = MAESTRO(roots["MAESTRO"], groups=train_groups,
                         sequence_length=sequence_length)
        validation_dataset = MAPS(roots["MAPS"],
                                  groups=["ENSTDkAm", "ENSTDkCl"],
                                  sequence_length=validation_length,
                                  overlap=True, refresh=refresh)
        full_validation = MAPS(roots["MAPS"], groups=["ENSTDkAm", "ENSTDkCl"],
                               sequence_length=None, refresh=refresh)
    elif dataset in ("Violin", "String", "Wind", "Flute"):
        group_map = {
            "Violin": ("train_violin_l", "train_violin_ul", "test_violin"),
            "String": ("train_string_l", "train_string_ul", "test_violin"),
            "Wind": ("train_wind_l", "train_wind_ul", "test_wind"),
            "Flute": ("train_flute_l", "train_flute_ul", "test_flute"),
        }
        l_g, ul_g, test_g = group_map[dataset]
        root = roots["MusicNet"]
        l_set = MusicNet(root, groups=[l_g],
                         sequence_length=sequence_length)
        ul_set = MusicNet(root, groups=[ul_g],
                          sequence_length=sequence_length)
        validation_dataset = MusicNet(root, groups=[test_g],
                                      sequence_length=validation_length)
        full_validation = MusicNet(root, groups=[test_g],
                                   sequence_length=None)
    elif dataset == "Guqin":
        root = roots["Guqin"]
        l_set = Guqin(root, groups=["train_l"],
                      sequence_length=sequence_length, refresh=refresh)
        ul_set = Guqin(root, groups=["train_ul"],
                       sequence_length=sequence_length, refresh=refresh)
        validation_dataset = Guqin(root, groups=["test"],
                                   sequence_length=validation_length,
                                   refresh=refresh)
        full_validation = Guqin(root, groups=["test"], sequence_length=None,
                                refresh=refresh)
    else:
        raise ValueError(f"Please choose the correct dataset: {dataset!r}")

    return l_set, ul_set, validation_dataset, full_validation


def prepare_dataset(train_on, sequence_length, validation_length,
                    leave_one_out, refresh, small=False, data_roots=None):
    """Supervised-only preparation (`model/helper_functions.py:23-49`)."""
    roots = _roots(data_roots)
    train_groups, validation_groups = ["train"], ["validation"]

    if leave_one_out is not None:
        all_years = {"2004", "2006", "2008", "2009", "2011", "2013", "2014",
                     "2015", "2017"}
        train_groups = list(all_years - {str(leave_one_out)})
        validation_groups = [str(leave_one_out)]

    if train_on == "MAESTRO":
        dataset = MAESTRO(roots["MAESTRO"], groups=train_groups,
                          sequence_length=sequence_length)
        validation_dataset = MAESTRO(roots["MAESTRO"],
                                     groups=validation_groups,
                                     sequence_length=sequence_length)
    elif train_on == "MusicNet":
        dataset = MusicNet(roots["MusicNet"], groups=["train"],
                           sequence_length=sequence_length, refresh=refresh)
        validation_dataset = MusicNet(roots["MusicNet"], groups=["test"],
                                      sequence_length=sequence_length,
                                      refresh=refresh)
    else:
        dataset = MAPS(roots["MAPS"],
                       groups=["AkPnBcht", "AkPnBsdf", "AkPnCGdD", "AkPnStgb",
                               "SptkBGAm", "SptkBGCl", "StbgTGd2"],
                       sequence_length=sequence_length, overlap=False,
                       refresh=refresh)
        validation_dataset = MAPS(roots["MAPS"],
                                  groups=["ENSTDkAm", "ENSTDkCl"],
                                  sequence_length=validation_length,
                                  overlap=True, refresh=refresh)

    full_validation = MAPS(roots["MAPS"], groups=["ENSTDkAm", "ENSTDkCl"],
                           sequence_length=None, refresh=refresh)
    return dataset, validation_dataset, full_validation
