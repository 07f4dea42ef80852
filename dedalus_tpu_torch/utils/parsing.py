"""
Equation-string parsing helpers.

Parity target: dedalus/tools/parsing.py (fresh implementation): split an
equation string on the single top-level '=' (ignoring ==, <=, >=, != and any
'=' nested inside brackets or quotes), and split function-call strings.
"""


def _top_level_positions(expression, char):
    """Positions of `char` at zero bracket depth, outside quotes."""
    depth = 0
    positions = []
    in_quote = None
    for i, c in enumerate(expression):
        if in_quote:
            if c == in_quote:
                in_quote = None
            continue
        if c in "\"'":
            in_quote = c
        elif c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif c == char and depth == 0:
            positions.append(i)
    return positions

def split_equation(equation):
    """Split 'LHS = RHS' on the top-level equals sign."""
    candidates = []
    for i in _top_level_positions(equation, '='):
        prev = equation[i-1] if i > 0 else ''
        nxt = equation[i+1] if i+1 < len(equation) else ''
        if prev in '=<>!' or nxt == '=':
            continue
        candidates.append(i)
    if len(candidates) != 1:
        raise ValueError(f"Equation must contain exactly one top-level equals sign: {equation!r}")
    i = candidates[0]
    return equation[:i].strip(), equation[i+1:].strip()


def split_call(expression):
    """Split 'head(arg1, arg2, ...)' into (head, (args...)), or (expression, ()) if not a call."""
    expression = expression.strip()
    if not expression.endswith(')'):
        return expression, ()
    # Find matching open paren for trailing close paren
    depth = 0
    for i in range(len(expression) - 1, -1, -1):
        c = expression[i]
        if c == ')':
            depth += 1
        elif c == '(':
            depth -= 1
            if depth == 0:
                head = expression[:i].strip()
                inner = expression[i+1:-1]
                if not head or not head.replace('_', 'a').replace('.', 'a').isalnum():
                    return expression, ()
                args = []
                start = 0
                for j in _top_level_positions(inner, ','):
                    args.append(inner[start:j].strip())
                    start = j + 1
                tail = inner[start:].strip()
                if tail:
                    args.append(tail)
                return head, tuple(args)
    return expression, ()


def lambdify_functions(call, result):
    """Build a lambda implementing `result` as a function of the arguments
    in the call signature string (parity: tools/parsing.py
    lambdify_functions): "f(x, y)" , "x + 2*y" -> ("f", callable)."""
    head, args = split_call(call)
    if not args:
        raise ValueError(f"Not a function call signature: {call!r}")
    src = f"lambda {', '.join(args)}: {result}"
    return head, eval(src)
