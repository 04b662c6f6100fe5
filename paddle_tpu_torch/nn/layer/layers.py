"""nn.Layer, the module system (paddle_tpu/nn/layer/layers.py:39-512).

The reference's own class, not a torch.nn.Module: it holds port
Parameters (``_parameters``), sublayers (``_sub_layers``) and buffers
(``_buffers``) under the reference's method names and return types:
``parameters()`` is a list, ``named_parameters`` walks in the reference's
order, and ``state_dict`` / ``set_state_dict`` use its structured names
(``model.layers.0.self_attn.q_proj.weight``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Tuple

from ...core.dtype import convert_dtype
from ...core.place import to_torch_device
from ...core.tensor import Parameter, to_torch

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict"]


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = convert_dtype(dtype)
        self._parameters = OrderedDict()
        self._sub_layers = OrderedDict()
        self._buffers = OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self._hook_id = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # -- registration -------------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ first")
            params[name] = value
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ first")
            layers[name] = value
            self.__dict__.pop(name, None)
        elif params is not None and name in params:
            if value is None:
                del params[name]
                object.__setattr__(self, name, None)
            else:
                params[name] = value
        elif buffers is not None and name in buffers:
            buffers[name] = value
        elif layers is not None and name in layers:
            if value is None:
                del layers[name]
                object.__setattr__(self, name, None)
            else:
                layers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self._parameters[str(name)] = parameter
        return parameter

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[str(name)] = tensor
        if tensor is not None:
            tensor.persistable = True
        if not persistable:
            self._non_persistable_buffer_names.add(str(name))
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new Parameter on the default place (core/place.py), drawn by
        ``default_initializer`` (Xavier-uniform, or zeros for a bias)."""
        from ..initializer import Constant, XavierUniform

        dtype = convert_dtype(dtype) or self._dtype
        init = default_initializer
        name = None
        if isinstance(attr, str):
            name = attr
        elif attr is not None and attr is not False:
            init = getattr(attr, "initializer", None) or init
            name = getattr(attr, "name", None)
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        data = init(shape, dtype, to_torch_device())
        return Parameter(data, name=name)

    # -- iteration ----------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False, layers_set=None
                        ) -> Iterator[Tuple[str, "Layer"]]:
        layers_set = layers_set if layers_set is not None else set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, sub in self._sub_layers.items():
            if sub is None:
                continue
            p = prefix + ("." if prefix else "") + name
            if id(sub) not in layers_set:
                layers_set.add(id(sub))
                yield p, sub
                yield from sub.named_sublayers(prefix=p, include_self=False,
                                               layers_set=layers_set)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def children(self):
        return (l for l in self._sub_layers.values() if l is not None)

    def named_children(self):
        return ((n, l) for n, l in self._sub_layers.items() if l is not None)

    def _traverse(self, prefix, include_sublayers):
        yield prefix, self
        if include_sublayers:
            yield from self.named_sublayers(prefix=prefix)

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for layer_prefix, layer in self._traverse(prefix, include_sublayers):
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (layer_prefix + ("." if layer_prefix else "") + name, p)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for layer_prefix, layer in self._traverse(prefix, include_sublayers):
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (layer_prefix + ("." if layer_prefix else "") + name, b)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    # -- mode ---------------------------------------------------------------
    def train(self):
        for l in self.sublayers(include_self=True):
            l.training = True
        return self

    def eval(self):
        for l in self.sublayers(include_self=True):
            l.training = False
        return self

    # -- hooks --------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- call ---------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, inputs, outputs)
            if res is not None:
                outputs = res
        return outputs

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        """{structured name: the live Parameter or buffer}."""
        dest = destination if destination is not None else OrderedDict()
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=prefix, include_sublayers=include_sublayers):
            dest[name] = p
        for name, b in self.named_buffers(
                prefix=prefix, include_sublayers=include_sublayers):
            if name.rsplit(".", 1)[-1] not in \
                    self._non_persistable_buffer_names:
                dest[name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values (Tensors, torch tensors, numpy arrays) into the
        entries of the same names, each cast to its entry's dtype and
        device; returns (missing, unexpected) names."""
        own = self.state_dict()
        missing, unexpected = [], []
        for name, target in own.items():
            if name in state_dict:
                v = to_torch(state_dict[name], place=target._value.device)
                target.set_value(v.to(target.dtype))
            else:
                missing.append(name)
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype / place ------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move (``device``) and cast (``dtype``, floating entries only)
        every parameter and buffer in place."""
        dev = None if device is None else to_torch_device(device)
        d = convert_dtype(dtype)

        def convert(t):
            v = t._value
            if d is not None and v.is_floating_point():
                v = v.to(d)
            if dev is not None:
                v = v.to(dev)
            if isinstance(t, Parameter):
                t._replace(v)
            else:
                t._value = v

        for layer in self.sublayers(include_self=True):
            for p in layer._parameters.values():
                if p is not None:
                    convert(p)
            for b in layer._buffers.values():
                if b is not None:
                    convert(b)
            if d is not None:
                layer._dtype = d
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_grad(set_to_zero)

    def __repr__(self):
        lines = []
        for name, sub in self._sub_layers.items():
            lines.append(f"({name}): " + "\n  ".join(repr(sub).split("\n")))
        main = self.__class__.__name__ + "(" + self.extra_repr()
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"

    def extra_repr(self):
        return ""


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = layers[0]
        if layers and isinstance(layers[0], tuple) and \
                isinstance(layers[0][0], str):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or ()):
            self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return self._sub_layers[str(self._abs_idx(idx))]

    def __setitem__(self, idx, layer):
        self._sub_layers[str(self._abs_idx(idx))] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def _abs_idx(self, idx):
        n = len(self._sub_layers)
        return idx % n if n else idx

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def keys(self):
        return self._sub_layers.keys()

    def values(self):
        return self._sub_layers.values()

    def items(self):
        return self._sub_layers.items()

    def update(self, sublayers):
        items = sublayers.items() if hasattr(sublayers, "items") \
            else sublayers
        for k, v in items:
            self[k] = v
        return self

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        return self._sub_layers.pop(key)
