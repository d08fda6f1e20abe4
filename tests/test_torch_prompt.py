"""The port's ``prompt`` CLI against the JAX package's: every option of every
group registered in the JAX registries prints the same YAML from both
``main``s, and both packages register the same options."""

import sys

import pytest


def _jax_groups():
    from liteasr_tpu import prompt

    return prompt._GROUPS


def _options():
    return [f"{group}.{option}" for group, registry in sorted(_jax_groups().items())
            for option in sorted(registry)]


def test_both_packages_register_the_same_options():
    from liteasr_tpu_torch import prompt

    jax_groups = _jax_groups()
    assert set(prompt.GROUPS) == set(jax_groups)
    for group, registry in jax_groups.items():
        assert set(prompt.GROUPS[group]) == set(registry), group


@pytest.mark.parametrize("option", _options())
def test_prints_the_jax_packages_yaml(option, monkeypatch, capsys):
    from liteasr_tpu import prompt as jax_prompt
    from liteasr_tpu_torch import prompt

    monkeypatch.setattr(sys, "argv", ["prompt", option])
    jax_prompt.main()
    want = capsys.readouterr().out
    prompt.main([option])
    got = capsys.readouterr().out
    assert got == want
    assert f"name: {option.split('.')[1]}" in got


def test_unknown_options_raise():
    from liteasr_tpu_torch import prompt

    with pytest.raises(ValueError, match="is not a module"):
        prompt.main(["dataset.x"])
    with pytest.raises(ValueError, match="unknown model 'nope'"):
        prompt.main(["model.nope"])
