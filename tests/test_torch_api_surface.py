"""The reference's public API below the package root is the port's.

For every public module of the reference (``audiotools_tpu``) that has
a port counterpart, every public name it defines must exist in the
port's module, and every public attribute of each class it defines,
inherited ones included, must exist on the port's class.  A public
module is the package root's own modules and those of ``formats``,
``meta``, ``sheets``, ``services``, ``utils`` and ``cli`` (its
``__init__``: each tool's surface is its command line, which
``test_torch_cli.py`` and the other tool suites hold to the
reference's).  The compute backend (``ops``, ``codecs``, ``ref``,
``parallel``, ``_native``) is the reference's JAX and NumPy machinery,
which the port rebuilt on its own kernels; it is not API.

A public name is one the module defines (by ``def``, ``class`` or
assignment) that does not start with "_"; a public attribute of a
class is one that does not start with "_", or one of the Python
protocol methods below that the reference defines in its classes.
``LEFT_OUT`` is the one list of exclusions, each with its reason; it
is empty.

Every module file of the reference, the compute backend's too, has a
port module of the same name, apart from the JAX-only modules that
``JAX_ONLY`` names, each with its port counterpart or the reason it
has none.
"""

import ast
import importlib
import importlib.util
import inspect
import os
import pkgutil

import pytest

import audiotools_tpu as ref

# the reference's names the port does not carry, with the reason
LEFT_OUT = {}

# the reference's module files with no port module of the same name:
# its JAX-only modules, each with the port's counterpart or the reason
JAX_ONLY = {
    "codecs.flac_dec_jax": "codecs/flac_dec.py (TorchFlacDecoder)",
    "codecs.alac_dec_jax": "codecs/alac_dec.py (TorchALACDecoder)",
    "codecs.wavpack_jax": "codecs/wavpack.py (encode_wavpack, "
                          "TorchWavPackDecoder)",
    "codecs.flac_dec_fast": "codecs/flac_dec.py: the reference's default "
                            "host C++ decoder; the port decodes on its "
                            "device, its C++ frame decoder "
                            "_native.flac_decode",
    "ops.pallas_bitpack": "ops/bitpack.py and csrc/pack_rows.cu",
    "codecs.padgrid": "none: it pads a final batch so that XLA compiles "
                      "fewer shapes, which eager torch does not need",
}

PUBLIC_PACKAGES = ("formats", "meta", "sheets", "services", "utils")
PROTOCOL = ("__len__", "__getitem__", "__setitem__", "__delitem__",
            "__iter__", "__contains__", "__eq__", "__ne__", "__add__",
            "__mul__", "__enter__", "__exit__", "__str__", "__int__",
            "__index__", "__call__")


def public_modules():
    names = ["audiotools_tpu", "audiotools_tpu.cli"]
    for info in pkgutil.iter_modules(ref.__path__):
        if not info.ispkg and not info.name.startswith("_"):
            names.append("audiotools_tpu." + info.name)
    for package in PUBLIC_PACKAGES:
        module = importlib.import_module("audiotools_tpu." + package)
        names.append(module.__name__)
        for info in pkgutil.iter_modules(module.__path__):
            names.append("%s.%s" % (module.__name__, info.name))
    return sorted(names)


def port_name(name):
    return "audiotools_tpu_torch" + name[len("audiotools_tpu"):]


def defined_names(module):
    with open(module.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                names.update(n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name))
    return sorted(n for n in names
                  if not n.startswith("_") and hasattr(module, n))


def class_attributes(cls):
    attrs = [a for a in dir(cls) if not a.startswith("_")]
    for name in PROTOCOL:
        if any(name in vars(k) for k in cls.__mro__
               if k.__module__.startswith("audiotools_tpu")):
            attrs.append(name)
    return sorted(attrs)


MODULES = public_modules()


@pytest.mark.parametrize("name", MODULES)
def test_every_public_module_has_a_port_counterpart(name):
    assert importlib.util.find_spec(port_name(name)) is not None


@pytest.mark.parametrize("name", MODULES)
def test_every_public_name_and_attribute_is_in_the_port(name):
    module = importlib.import_module(name)
    port = importlib.import_module(port_name(name))
    missing = []
    for attr in defined_names(module):
        key = "%s.%s" % (name, attr)
        if key in LEFT_OUT:
            continue
        if not hasattr(port, attr):
            missing.append(attr)
            continue
        obj = getattr(module, attr)
        if inspect.isclass(obj) and obj.__module__.startswith(
                "audiotools_tpu"):
            port_cls = getattr(port, attr)
            missing.extend("%s.%s" % (attr, a) for a in class_attributes(obj)
                           if not hasattr(port_cls, a))
    assert missing == []


def test_the_left_out_names_exist_in_the_reference():
    # an exclusion names something the reference still has
    for key in LEFT_OUT:
        (module, attr) = key.rsplit(".", 1)
        assert hasattr(importlib.import_module(module), attr), key


def reference_module_files():
    """every module file of the reference package, as dotted names
    below it"""
    root = os.path.dirname(ref.__file__)
    names = []
    for (directory, _dirs, files) in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(directory, name), root)
                dotted = rel[:-3].replace(os.sep, ".")
                if dotted.endswith("__init__"):
                    dotted = dotted[:-len("__init__")].rstrip(".")
                names.append(dotted)
    return sorted(names)


def full_name(package, name):
    return package + "." + name if name else package


@pytest.mark.parametrize("name", reference_module_files())
def test_every_reference_module_file_has_a_port_module(name):
    spec = importlib.util.find_spec(full_name("audiotools_tpu_torch", name))
    if name in JAX_ONLY:
        assert spec is None, "%s is ported: take it out of JAX_ONLY" % (name,)
    else:
        assert spec is not None


def test_the_jax_only_modules_exist_in_the_reference():
    for name in JAX_ONLY:
        assert importlib.util.find_spec("audiotools_tpu." + name), name


@pytest.mark.parametrize("name", ["sheets", "pcmstream", "sines", "utils",
                                  "cli", "formats", "meta"])
def test_the_root_reaches_the_submodules_as_the_references(name):
    import audiotools_tpu_torch as port
    assert getattr(port, name).__name__ == "audiotools_tpu_torch." + name
